"""Launcher of the CUDA sLSTM cell kernel (``slstm_cell.cu``).

``slstm_cell_cuda(pre_x, r)`` checks its tensors, allocates the output,
launches the kernel on the current stream and adds one to
``launches``. It takes CUDA tensors only: there is no CPU path here
(``ops.slstm_cell`` routes CPU tensors to ``ref.py``). The library is
built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("slstm_cell.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

MAX_HEAD_DIM = 256  # kMaxHd in slstm_cell.cu: 4*hd threads a block

_ENTRY = {torch.float32: "slstm_cell_f32", torch.bfloat16: "slstm_cell_bf16"}
_fns: dict = {}


def _fn(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def slstm_cell_cuda(pre_x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """pre_x (B, H, S, 4, hd) and r (H, hd, 4hd), both f32 or both bf16,
    contiguous on one CUDA device, hd <= 256. Returns h (B, H, S, hd) in
    their dtype."""
    global launches
    if pre_x.dtype not in _ENTRY or r.dtype != pre_x.dtype:
        raise ValueError(f"slstm_cell_cuda takes float32 or bfloat16 of one "
                         f"dtype, got pre_x {pre_x.dtype}, r {r.dtype}")
    if pre_x.dim() != 5 or pre_x.shape[3] != 4:
        raise ValueError(f"want pre_x (B, H, S, 4, hd), got {tuple(pre_x.shape)}")
    b, h, s, _, hd = pre_x.shape
    if tuple(r.shape) != (h, hd, 4 * hd):
        raise ValueError(f"want r (H, hd, 4hd) = {(h, hd, 4 * hd)}, got "
                         f"{tuple(r.shape)}")
    if not (pre_x.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm_cell_cuda takes contiguous tensors")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_cell_cuda takes a head dim of at most "
                         f"{MAX_HEAD_DIM} (4*hd threads a block), got {hd}")
    if b * h > 2**31 - 1:
        raise ValueError(f"{b * h} (batch, head) pairs exceed the grid")
    if pre_x.device.type != "cuda" or r.device != pre_x.device:
        raise ValueError(f"slstm_cell_cuda takes CUDA tensors on one device, "
                         f"got pre_x on {pre_x.device}, r on {r.device}")
    out = torch.empty((b, h, s, hd), dtype=pre_x.dtype, device=pre_x.device)
    if out.numel() == 0:
        return out
    fn = _fn(pre_x.dtype)
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream(pre_x.device).cuda_stream
        err = fn(pre_x.data_ptr(), r.data_ptr(), out.data_ptr(), b, h, s, hd,
                 stream)
    if err != 0:
        raise RuntimeError(f"slstm_cell kernel launch failed: CUDA error {err}")
    launches += 1
    return out
