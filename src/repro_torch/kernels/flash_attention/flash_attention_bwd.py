"""Launcher of the CUDA flash attention backward (``flash_attention_bwd.cu``).

``flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=, window=,
softcap=)`` allocates dq, dk and dv and launches the source's kernels on
the current stream, adding one to ``launches`` for each: where Sq and Sk
are at most 64 and each K/V head serves one query head (the encoder's
S = 64) one fused kernel a call, one block a (batch, head); else two (dq
and the row sums D = rowsum(dout o out), written to a scratch, over
query blocks; then dk and dv over key blocks, each summed over its K/V
head's query heads). ``kernels_a_call(sq, sk, group)`` is that choice,
by shape and group alone. The forms are the forward's: grouped K/V
heads, causal and sliding-window masks, the logit cap. CUDA tensors
only (``ops.FlashAttentionFn`` routes CPU tensors to
``ref.flash_attention_bwd_ref``); built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.flash_attention import MAX_HEAD_DIM

SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")

# Kernel launches made by this process (kernels_a_call a backward);
# callers reset it to 0 to count the launches of one run.
launches = 0
TILE = 64  # kTile in flash_attention_bwd.cu: query rows and keys a block
MAX_TILES = 65535  # the grid's y limit, in tiles of Sq or Sk


def kernels_a_call(sq: int, sk: int, group: int = 1) -> int:
    """Launches of one backward: 1 (the fused kernel) where the (batch,
    head) is one tile, Sq and Sk at most 64, and ``group`` (query heads a
    K/V head) is 1; else 2 (dq, then dk and dv)."""
    return 1 if sq <= TILE and sk <= TILE and group == 1 else 2

_fns: dict = {}


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _build.load(SOURCE).flash_attention_bwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool,
                             window: int = 0, softcap: float = 0.0):
    """q, out, dout (B, Hq, Sq, d); k, v (B, Hkv, Sk, d), Hq a multiple of
    Hkv; lse (B, Hq, Sq); all f32 on one CUDA device, d a multiple of 4
    and at most 256. ``window`` (0: none) and ``softcap`` (0: none) as the
    forward took them. Returns (dq, dk, dv)."""
    global launches
    ts = (q, k, v, out, dout, lse)
    if any(x.dtype != torch.float32 for x in ts):
        raise ValueError(f"flash_attention_bwd_cuda takes float32, got "
                         f"{[x.dtype for x in ts]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B, Hq, Sq, d), k and v (B, Hkv, Sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv
            or out.shape != q.shape or dout.shape != q.shape
            or tuple(lse.shape) != (b, hq, sq)):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd_cuda takes a head dim that is a "
                         f"multiple of 4, at most {MAX_HEAD_DIM}; got {d}")
    if -(-sq // TILE) > MAX_TILES or -(-sk // TILE) > MAX_TILES or b * hq > 2**31 - 1:
        raise ValueError(f"({b * hq}, {sq}, {sk}) exceed the grid")
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be 0 (no cap) or positive, got {softcap}")
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in ts):
        raise ValueError(f"flash_attention_bwd_cuda takes CUDA tensors on one "
                         f"device, got {[str(x.device) for x in ts]}")
    q, k, v, out, dout, lse = ts = tuple(x.contiguous() for x in ts)
    if any(x.data_ptr() % 16 for x in ts):
        raise ValueError("flash_attention_bwd_cuda takes 16-byte aligned tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    n = kernels_a_call(sq, sk, hq // hkv)
    dd = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if n == 2
          else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(*(x.data_ptr() for x in (q, k, v, out, dout, lse)),
                    None if dd is None else dd.data_ptr(),
                    *(x.data_ptr() for x in (dq, dk, dv)),
                    b, hq, hkv, sq, sk, d, int(bool(causal)), max(int(window), 0),
                    float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    launches += n
    return dq, dk, dv
