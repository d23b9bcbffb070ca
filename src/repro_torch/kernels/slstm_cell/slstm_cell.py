"""Launcher of the CUDA sLSTM cell kernel (``slstm_cell.cu``).

``slstm_cell_cuda(pre_x, r)`` checks its tensors, allocates the output
(and, with ``return_state``, the final state), launches the kernel on
the current stream and adds one to ``launches``; ``initial_state``
starts the recurrence from a given (c, n, m, h) instead of the zero
state. It takes CUDA tensors only: there is no CPU path here
(``ops.slstm_cell`` routes CPU tensors to ``ref.py``). The library is
built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_cell.ref import zero_state as _zero_state

SOURCE = Path(__file__).with_name("slstm_cell.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

MAX_HEAD_DIM = 256  # kMaxHd in slstm_cell.cu: 4*hd threads a block

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict = {}


def _fn(dtype):
    """The C entry point slstm_cell_<dtype>: three tensors, eight state
    pointers (null for the zero state or a state not written), four
    ints and the stream."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), f"slstm_cell_{_ENTRY[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check_state(state, b: int, h: int, hd: int, device) -> None:
    if len(state) != 4:
        raise ValueError(f"want the state (c, n, m, h), got {len(state)} tensors")
    for x in state:
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, hd)
                or not x.is_contiguous() or x.device != device):
            raise ValueError(f"want each state tensor float32, contiguous, "
                             f"{(b, h, hd)} on {device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def slstm_cell_cuda(pre_x: torch.Tensor, r: torch.Tensor, initial_state=None,
                    return_state: bool = False):
    """pre_x (B, H, S, 4, hd) and r (H, hd, 4hd), both f32 or both bf16,
    contiguous on one CUDA device, hd <= 256; initial_state None or
    (c, n, m, h), each a contiguous (B, H, hd) f32 tensor there. Returns
    h (B, H, S, hd) in their dtype, and the final (c, n, m, h) with
    ``return_state``."""
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
    if initial_state is not None:
        _check_state(initial_state, b, h, hd, pre_x.device)
    if pre_x.device.type != "cuda" or r.device != pre_x.device:
        raise ValueError(f"slstm_cell_cuda takes CUDA tensors on one device, "
                         f"got pre_x on {pre_x.device}, r on {r.device}")
    out = torch.empty((b, h, s, hd), dtype=pre_x.dtype, device=pre_x.device)
    final = None
    if return_state and s == 0:  # nothing to run: the state passes through
        final = tuple(x.clone() for x in (
            initial_state if initial_state is not None
            else _zero_state(b, h, hd, pre_x.device)))
    elif return_state:
        final = tuple(torch.empty((b, h, hd), dtype=torch.float32,
                                  device=pre_x.device) for _ in range(4))
    if out.numel() == 0:
        return (out, final) if return_state else out
    fn = _fn(pre_x.dtype)
    ptrs = tuple(None if x is None else x.data_ptr() for x in (
        *(initial_state or (None,) * 4), *(final or (None,) * 4)))
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream(pre_x.device).cuda_stream
        err = fn(pre_x.data_ptr(), r.data_ptr(), out.data_ptr(), *ptrs, b, h,
                 s, hd, stream)
    if err != 0:
        raise RuntimeError(f"slstm_cell kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, final) if return_state else out
