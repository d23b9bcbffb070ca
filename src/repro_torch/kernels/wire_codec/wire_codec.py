"""Launcher of the CUDA wire-codec kernels (``wire_codec.cu``).

``wire_codec_fused(x, k=, quantize=)`` is the whole round trip on the
card: each row's int8 scale and top-k threshold, selected in the
kernels, then the codec pass. It returns the decoded rows and the
(L, 2) f32 [scale, thresh] the kernels selected. The CUDA work of one
call:

- N <= ``NARROW_MAX`` (every serving message): one kernel,
  ``narrow_kernel`` (one CTA a row, the row in shared memory);
- wider rows: a memset of the workspace, then ``hist_kernel`` once a
  digit pass (three for a sparse f32 call, two for a sparse bf16 call,
  one for a dense call, which only takes the largest |x|), then
  ``pass_kernel``; no value is read on the host.

``wire_codec_cuda(x, scale_thresh, quantize=)`` is the pass alone, given
each row's [scale, thresh]: one ``pass_kernel``. Each of the two adds
one to ``launches`` a call. They take CUDA tensors only: there is no
CPU path here (``ops.wire_codec_roundtrip`` routes CPU tensors to
``ref.py``). The library is built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, on_device

SOURCE = Path(__file__).with_name("wire_codec.cu")

# Calls of the codec (either entry) made by this process; callers reset
# it to 0 to count the calls of one run.
launches = 0

NARROW_MAX = 8192  # kNarrowMax in wire_codec.cu: a row in one CTA's shared memory
WS_WORDS = 2052  # kWsWords: uint32 workspace words a wide row
# (shift, width) of each digit of the 32-bit |x| key, in the order the
# kernels select them (kShift, kWidth); a bf16 key needs the first two
DIGITS = ((21, 11), (10, 11), (0, 10))
MAX_WIDE_ROWS = 65535  # the grid's y limit: one grid row a message row

_PASS = {torch.float32: "wire_codec_f32", torch.bfloat16: "wire_codec_bf16"}
_FUSED = {torch.float32: "wire_codec_fused_f32",
          torch.bfloat16: "wire_codec_fused_bf16"}
_ARGS = {"pass": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_void_p],
         "fused": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]}
_fns: dict = {}


def _fn(name, kind):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(SOURCE), name)
        fn.argtypes = _ARGS[kind]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def wire_codec_cuda(x: torch.Tensor, scale_thresh: torch.Tensor, *,
                    quantize: bool) -> torch.Tensor:
    """x (L, N) f32/bf16 and scale_thresh (L, 2) f32, both contiguous on
    one CUDA device. Returns the (L, N) decoded reconstruction."""
    global launches
    if x.device.type != "cuda" or scale_thresh.device != x.device:
        raise ValueError(f"wire_codec_cuda takes CUDA tensors on one device, "
                         f"got x on {x.device}, scale_thresh on "
                         f"{scale_thresh.device}")
    if x.dtype not in _PASS:
        raise ValueError(f"wire_codec_cuda takes float32 or bfloat16, got {x.dtype}")
    if scale_thresh.dtype != torch.float32:
        raise ValueError(f"scale_thresh must be float32, got {scale_thresh.dtype}")
    if x.dim() != 2 or tuple(scale_thresh.shape) != (x.shape[0], 2):
        raise ValueError(f"want x (L, N) and scale_thresh (L, 2), got "
                         f"{tuple(x.shape)} and {tuple(scale_thresh.shape)}")
    if not (x.is_contiguous() and scale_thresh.is_contiguous()):
        raise ValueError("wire_codec_cuda takes contiguous tensors")
    rows, n = x.shape
    if rows > MAX_WIDE_ROWS:
        raise ValueError(f"{rows} rows exceed the grid's y limit of {MAX_WIDE_ROWS}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _fn(_PASS[x.dtype], "pass")
    with on_device(x.device):
        err = fn(x.data_ptr(), scale_thresh.data_ptr(), out.data_ptr(),
                 rows, n, int(bool(quantize)),
                 torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"wire_codec kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def wire_codec_fused(x: torch.Tensor, *, k: int | None,
                     quantize: bool) -> tuple:
    """x (L, N) f32/bf16, contiguous on a CUDA device; keep the k largest
    |x| of each row (None, or k >= N: dense). Returns (the (L, N) decoded
    reconstruction, the (L, 2) f32 [scale, thresh] of each row)."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"wire_codec_fused takes CUDA tensors, got x on {dev}")
    if x.dtype not in _FUSED:
        raise ValueError(f"wire_codec_fused takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"wire_codec_fused takes a contiguous (L, N) x, got "
                         f"{tuple(x.shape)}")
    if k is not None and k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    rows, n = x.shape
    wide = n > NARROW_MAX
    if wide and rows > MAX_WIDE_ROWS:
        raise ValueError(f"{rows} rows of {n} exceed the grid's y limit of "
                         f"{MAX_WIDE_ROWS}")
    out = torch.empty_like(x)
    st = torch.empty(rows, 2, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, st
    ws = torch.empty(rows, WS_WORDS, dtype=torch.int32, device=dev) if wide else None
    fn = _fn(_FUSED[x.dtype], "fused")
    with on_device(dev):
        err = fn(x.data_ptr(), out.data_ptr(), st.data_ptr(),
                 None if ws is None else ws.data_ptr(), rows, n,
                 n if k is None else min(k, n), int(bool(quantize)),
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"wire_codec kernel launch failed: CUDA error {err}")
    launches += 1
    return out, st
