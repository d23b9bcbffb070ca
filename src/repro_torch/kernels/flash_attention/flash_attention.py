"""Launcher of the CUDA flash attention kernel (``flash_attention.cu``).

``flash_attention_cuda(q, k, v, causal=, window=, softcap=)`` checks its
tensors, allocates the output (and, with ``return_lse``, each row's log-sum-exp
for the backward, ``flash_attention_bwd.py``), launches the kernel on
the current stream and adds one to ``launches``. It takes CUDA tensors only: there is no CPU
path here (``ops.flash_attention`` routes CPU tensors to ``ref.py``).
The library is built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("flash_attention.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

MAX_HEAD_DIM = 256  # kMaxD in flash_attention.cu
BLOCK_M = 64  # kBlockM in flash_attention.cu: query rows a block
# A block's rows run over every query head of one K/V group, so the grid
# holds (B * Hkv, ceil(group * Sq / BLOCK_M)) blocks: y at most 65535.
MAX_GROUP_ROWS = 65535 * BLOCK_M  # (Hq / Hkv) * Sq, at most
MAX_KV_PAIRS = 2**31 - 1  # B * Hkv, the grid's x limit

_ENTRY = {torch.float32: "flash_attention_kv_f32",
          torch.bfloat16: "flash_attention_kv_bf16"}
_fns: dict = {}


def _fn(dtype):
    """The C entry point flash_attention_kv_<dtype>: four tensors, the
    log-sum-exp pointer (null for none), eight ints, the softcap, K/V's
    three element strides (batch, head, key row) and the stream."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, window: int, softcap: float = 0.0,
                         return_lse: bool = False):
    """q (B, Hq, Sq, d), k and v (B, Hkv, Sk, d), one dtype (f32 or bf16),
    on one CUDA device; q contiguous, k and v of one set of strides with
    the head dim contiguous (read where they lie: a decode cache's
    (B, L, Hkv, d) slots need no copy); Hq % Hkv == 0, d <= 256, (Hq /
    Hkv) * Sq <= MAX_GROUP_ROWS. ``window`` of
    0 or less means no window, as in the reference; ``softcap`` > 0 caps
    each scaled score s to softcap * tanh(s / softcap) (0: no cap).
    Returns (B, Hq, Sq, d)
    in q's dtype, and with ``return_lse`` the (B, Hq, Sq) f32 log-sum-exp
    of each row's scaled scores (in bf16 too: the kernel keeps its row
    maxima and sums in f32); the output is the same bit for bit."""
    global launches
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Hq, Sq, d) and k, v (B, Hkv, Sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(same batch and d, Hq a multiple of Hkv)")
    if not q.is_contiguous():
        raise ValueError("flash_attention_cuda takes a contiguous q")
    if k.stride() != v.stride() or (d > 1 and k.stride(3) != 1):
        raise ValueError(f"flash_attention_cuda takes k and v of one set of "
                         f"strides with the head dim contiguous, got "
                         f"{k.stride()} and {v.stride()}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda takes a head dim of at most "
                         f"{MAX_HEAD_DIM}, got {d}")
    if (hq // hkv) * sq > MAX_GROUP_ROWS or b * hkv > MAX_KV_PAIRS:
        raise ValueError(f"{hq // hkv} x {sq} query rows of a K/V group (at "
                         f"most {MAX_GROUP_ROWS}) or {b * hkv} (batch, K/V "
                         f"head) pairs (at most {MAX_KV_PAIRS}) exceed the grid")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda takes CUDA tensors on one "
                         f"device, got q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be 0 (no cap) or positive, got {softcap}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    fn = _fn(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, hq, hkv, sq, sk, d, int(bool(causal)),
                 max(int(window), 0), float(softcap), k.stride(0), k.stride(1),
                 k.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
