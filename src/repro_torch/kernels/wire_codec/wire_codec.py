"""Launcher of the CUDA wire-codec kernel (``wire_codec.cu``).

``wire_codec_cuda(x, scale_thresh, quantize=)`` checks its tensors,
allocates the output, launches the kernel on the current stream and
adds one to ``launches``. It takes CUDA tensors only: there is no CPU
path here (``ops.wire_codec_roundtrip`` routes CPU tensors to
``ref.py``). The library is built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("wire_codec.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

_ENTRY = {torch.float32: "wire_codec_f32", torch.bfloat16: "wire_codec_bf16"}
_fns: dict = {}


def _fn(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
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
    if x.dtype not in _ENTRY:
        raise ValueError(f"wire_codec_cuda takes float32 or bfloat16, got {x.dtype}")
    if scale_thresh.dtype != torch.float32:
        raise ValueError(f"scale_thresh must be float32, got {scale_thresh.dtype}")
    if x.dim() != 2 or tuple(scale_thresh.shape) != (x.shape[0], 2):
        raise ValueError(f"want x (L, N) and scale_thresh (L, 2), got "
                         f"{tuple(x.shape)} and {tuple(scale_thresh.shape)}")
    if not (x.is_contiguous() and scale_thresh.is_contiguous()):
        raise ValueError("wire_codec_cuda takes contiguous tensors")
    rows, n = x.shape
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the grid's y limit of 65535")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale_thresh.data_ptr(), out.data_ptr(),
                 rows, n, int(bool(quantize)), stream)
    if err != 0:
        raise RuntimeError(f"wire_codec kernel launch failed: CUDA error {err}")
    launches += 1
    return out
