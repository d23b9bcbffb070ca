"""Launcher of the CUDA mLSTM scan kernel (``mlstm_scan.cu``).

``mlstm_scan_cuda(q, k, v, log_f, ...)`` checks its tensors, allocates
h and, with ``return_state``, the final (C, n), launches the kernel on
the current stream and adds one to ``launches``. It takes CUDA tensors
only: there is no CPU path here (``ops.mlstm_scan`` routes CPU tensors
to ``ref.py``). The library is built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("mlstm_scan.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

TILES = (16, 32, 64, 128)  # the chunk lengths the kernel is built for
MAX_SMEM_BYTES = 232448    # dynamic shared memory a block may have (sm_90)
DV_BLOCK, TK = 64, 32      # kDvBlock, kTk in mlstm_scan.cu

_fns: dict = {}


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _build.load(SOURCE).mlstm_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def tile(chunk: int, s: int) -> int:
    """The kernel's chunk length for ``chunk`` at sequence length ``s``:
    the smallest of TILES that holds min(chunk, s), as the TPU kernel
    takes min(chunk, s). The result does not depend on it beyond f32
    rounding."""
    want = min(chunk, s)
    if chunk < 1 or want > TILES[-1]:
        raise ValueError(f"mlstm_scan_cuda takes a chunk of 1..{TILES[-1]}, "
                         f"got {chunk}")
    return next(t for t in TILES if t >= want)


def smem_bytes(chunk: int, dk: int) -> int:
    """Dynamic shared memory of one block (smem_floats in the source)."""
    dkp = -(-dk // TK) * TK
    return 4 * (dkp * DV_BLOCK + dkp + 2 * chunk * (TK + 4) + chunk * DV_BLOCK
                + chunk * (chunk + 4) + 5 * chunk)


def mlstm_scan_cuda(q, k, v, log_f, *, chunk: int = 64, normalize: bool = True,
                    return_state: bool = False):
    """q, k (B, H, S, dk), v (B, H, S, dv), log_f (B, H, S): float32,
    contiguous, on one CUDA device. Returns h (B, H, S, dv) in f32, and
    the final (C (B, H, dk, dv), n (B, H, dk)) with ``return_state``."""
    global launches
    named = (("q", q), ("k", k), ("v", v), ("log_f", log_f))
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"mlstm_scan_cuda takes float32, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("mlstm_scan_cuda takes contiguous tensors")
    if q.dim() != 4:
        raise ValueError(f"want q (B, H, S, dk), got {tuple(q.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    if (tuple(k.shape) != (b, h, s, dk) or tuple(v.shape) != (b, h, s, dv)
            or tuple(log_f.shape) != (b, h, s)):
        raise ValueError(f"want k {(b, h, s, dk)}, v (B, H, S, dv), log_f "
                         f"{(b, h, s)}; got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_f.shape)}")
    if b * h > 2**31 - 1:
        raise ValueError(f"{b * h} (batch, head) pairs exceed the grid")
    length = tile(chunk, max(s, 1))
    need = smem_bytes(length, dk)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"mlstm_scan_cuda at chunk {length} and dk {dk} needs "
                         f"{need} bytes of shared memory a block, above the "
                         f"{MAX_SMEM_BYTES} an SM gives: use a smaller chunk")
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"mlstm_scan_cuda takes CUDA tensors on one "
                             f"device, got {name} on {x.device}")
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=q.device)
    run = bool(b * h and s and dk and dv)
    c = n = None
    if return_state:  # a launch writes every entry; else the zero state
        new = torch.empty if run else torch.zeros
        c = new((b, h, dk, dv), dtype=torch.float32, device=q.device)
        n = new((b, h, dk), dtype=torch.float32, device=q.device)
    if run:
        fn = _fn()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                     out.data_ptr(), None if c is None else c.data_ptr(),
                     None if n is None else n.data_ptr(), b * h, s, dk, dv,
                     length, int(normalize), stream)
        if err != 0:
            raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error {err}")
        launches += 1
    return (out, (c, n)) if return_state else out
