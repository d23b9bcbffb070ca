"""Launcher of the CUDA sLSTM backward kernel (``slstm_cell_bwd.cu``).

``slstm_cell_bwd_cuda(saved, r, dhs)`` takes what the forward saved
(``slstm_cell_cuda(..., save=True)``), the recurrent weights and the
gradient of the output, allocates the gradient of the gate
pre-activations, launches the kernel on the current stream and adds one
to ``launches``. CUDA tensors only (``ops.SLSTMCellFn`` routes CPU
tensors to ``ref.slstm_cell_bwd_ref``); built on first call, never at
import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_cell.slstm_cell import MAX_HEAD_DIM, SAVE_SLOTS

SOURCE = Path(__file__).with_name("slstm_cell_bwd.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

_fns: dict = {}


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _build.load(SOURCE).slstm_cell_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def slstm_cell_bwd_cuda(saved: torch.Tensor, r: torch.Tensor,
                        dhs: torch.Tensor) -> torch.Tensor:
    """saved (C*B, H, S, 7, hd), r (H, hd, 4hd) or (C, H, hd, 4hd), dhs
    (C*B, H, S, hd), all f32 on one CUDA device, hd a multiple of 4 and at
    most 256. Returns dpre (C*B, H, S, 4, hd) f32, the gradient of each
    step's gate pre-activations."""
    global launches
    if any(x.dtype != torch.float32 for x in (saved, r, dhs)):
        raise ValueError(f"slstm_cell_bwd_cuda takes float32, got {saved.dtype}, "
                         f"{r.dtype}, {dhs.dtype}")
    if dhs.dim() != 4:
        raise ValueError(f"want dhs (C*B, H, S, hd), got {tuple(dhs.shape)}")
    rows, h, s, hd = dhs.shape
    clients = r.shape[0] if r.dim() == 4 else 1
    if (r.dim() not in (3, 4) or tuple(r.shape[-3:]) != (h, hd, 4 * hd)
            or rows % clients
            or tuple(saved.shape) != (rows, h, s, SAVE_SLOTS, hd)):
        raise ValueError(f"saved {tuple(saved.shape)}, r {tuple(r.shape)} do "
                         f"not match dhs {tuple(dhs.shape)}")
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_cell_bwd_cuda takes a head dim that is a "
                         f"multiple of 4, at most {MAX_HEAD_DIM}; got {hd}")
    dev = dhs.device
    if dev.type != "cuda" or saved.device != dev or r.device != dev:
        raise ValueError(f"slstm_cell_bwd_cuda takes CUDA tensors on one "
                         f"device, got {saved.device}, {r.device}, {dev}")
    dpre = torch.empty((rows, h, s, 4, hd), dtype=torch.float32, device=dev)
    if dpre.numel() == 0:
        return dpre
    rt = r.transpose(-1, -2).contiguous()  # (C, H, 4hd, hd)
    saved, dhs = saved.contiguous(), dhs.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(saved.data_ptr(), rt.data_ptr(), dhs.data_ptr(),
                    dpre.data_ptr(), clients, rows // clients, h, s, hd, stream)
    if err != 0:
        raise RuntimeError(f"slstm_cell_bwd kernel launch failed: CUDA error {err}")
    launches += 1
    return dpre
