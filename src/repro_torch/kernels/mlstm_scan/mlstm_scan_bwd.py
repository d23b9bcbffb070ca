"""Launcher of the CUDA mLSTM-scan backward kernel (``mlstm_scan_bwd.cu``).

``mlstm_scan_bwd_cuda(q, k, v, log_f, h, dh, normalize=...)`` checks its
tensors, allocates the four gradients (and, with ``normalize``, the
scratch of the normalize step's backward), launches the kernels on the
current stream and adds one to ``launches``. A call is three kernels with
``normalize`` (``mlstm_bwd_prep``, ``mlstm_bwd_scan``, ``mlstm_bwd_dlogf``)
and two without; ``KERNELS`` names them for the profiler. It takes CUDA
tensors only: there is no CPU path here (``ops.MLSTMScanFn`` routes CPU
tensors to ``ref.mlstm_scan_bwd_ref``). The library is built on first
call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("mlstm_scan_bwd.cu")

# Backward calls made by this process (each one launch of every kernel
# of KERNELS it runs); callers reset it to 0 to count the calls of one run.
launches = 0

KERNELS = ("mlstm_bwd_prep", "mlstm_bwd_scan", "mlstm_bwd_dlogf")
CHUNK = 64       # kL: the backward's own chunk, whatever the forward's
COLS = 64        # kCols: value columns a scan CTA owns
QUERY_TILE = 32  # kTP
MAX_SMEM_BYTES = 232448
MAX_DK_NORMALIZE = 1024  # kMaxDk: the prep kernel keeps n in registers

_fns: dict = {}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(dk: int, dv: int, normalize: bool) -> int:
    """Dynamic shared memory of a scan CTA (``mlstm_bwd_smem_bytes``):
    the state of the widest query axis (dv + 1 with ``normalize``, dv, or
    dk) by 64 columns, two query tiles, the value and score tiles, three
    rows of weights."""
    p = max(dv + int(normalize), dk)
    return 4 * (_round_up(p, QUERY_TILE) * COLS + 2 * CHUNK * (QUERY_TILE + 1)
                + 2 * CHUNK * (COLS + 1) + 3 * CHUNK)


def kernel_launches(normalize: bool) -> int:
    """Kernels one call launches."""
    return 3 if normalize else 2


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _build.load(SOURCE).mlstm_scan_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def mlstm_scan_bwd_cuda(q, k, v, log_f, h, dh, *, normalize: bool = True):
    """q, k (B, H, S, dk), v, h, dh (B, H, S, dv), log_f (B, H, S): float32,
    contiguous, on one CUDA device; h is the forward's output (read with
    ``normalize`` only). Returns (dq, dk, dv, dlog_f) in f32."""
    global launches
    named = (("q", q), ("k", k), ("v", v), ("log_f", log_f), ("h", h),
             ("dh", dh))
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"mlstm_scan_bwd_cuda takes float32, got {name} "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError("mlstm_scan_bwd_cuda takes contiguous tensors")
    if q.dim() != 4:
        raise ValueError(f"want q (B, H, S, dk), got {tuple(q.shape)}")
    b, nh, s, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    if (tuple(k.shape) != (b, nh, s, dk) or tuple(v.shape) != (b, nh, s, dv)
            or tuple(h.shape) != (b, nh, s, dv) or tuple(dh.shape) != (b, nh, s, dv)
            or tuple(log_f.shape) != (b, nh, s)):
        raise ValueError(f"want k {(b, nh, s, dk)}, v, h, dh (B, H, S, dv), "
                         f"log_f {(b, nh, s)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}, {tuple(log_f.shape)}")
    if normalize and dk > MAX_DK_NORMALIZE:
        raise ValueError(f"mlstm_scan_bwd_cuda with normalize takes dk <= "
                         f"{MAX_DK_NORMALIZE}, got {dk}")
    need = smem_bytes(dk, max(dv, 1), normalize)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"mlstm_scan_bwd_cuda at dk {dk}, dv {dv} needs {need} "
                         f"bytes of shared memory a block, above the "
                         f"{MAX_SMEM_BYTES} an SM gives")
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"mlstm_scan_bwd_cuda takes CUDA tensors on one "
                             f"device, got {name} on {x.device}")
    if not (b * nh and s and dk and dv):
        return tuple(torch.zeros_like(x) for x in (q, k, v, log_f))
    # the kernels write every entry
    dq, dkk, dvv, dlf = (torch.empty_like(x) for x in (q, k, v, log_f))
    du = ds = None
    if normalize:
        du = torch.empty_like(dh)
        ds = torch.empty_like(log_f)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                    h.data_ptr(), dh.data_ptr(), dq.data_ptr(), dkk.data_ptr(),
                    dvv.data_ptr(), dlf.data_ptr(),
                    None if du is None else du.data_ptr(),
                    None if ds is None else ds.data_ptr(), b * nh, s, dk, dv,
                    int(normalize), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan_bwd kernel launch failed: CUDA error {err}")
    launches += 1
    return dq, dkk, dvv, dlf
