"""Public wrapper of the sLSTM cell kernel.

``slstm_cell(pre_x, r)`` runs the stabilized sLSTM recurrence over the
whole sequence from the zero state, or from ``initial_state``, and with
``return_state`` also returns the final state. ``r`` of shape (C, H, hd,
4hd) runs C clients' stacked rows in one call. A CUDA tensor goes
through the CUDA kernel; only a CPU tensor takes the plain version.

Where a gradient is wanted (autograd on, an input that requires it) the
call goes through ``SLSTMCellFn``: the forward kernel also saves each
step's gate sums and state, and the backward runs the BPTT kernel
(``slstm_cell_bwd.cu``) or, for CPU tensors, the plain backward; the
gradient of r is one batched product after either. That path takes f32
(the models cast their pre-activations and r up before the cell, in bf16
compute too) from the zero state and returns no final state: a state's
gradient is refused (ROADMAP item 15c-2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm_cell.ref import (
    recurrent_grad,
    slstm_cell_bwd_ref,
    slstm_cell_ref,
)
from repro_torch.kernels.slstm_cell.slstm_cell import slstm_cell_cuda
from repro_torch.kernels.slstm_cell.slstm_cell_bwd import slstm_cell_bwd_cuda


class SLSTMCellFn(torch.autograd.Function):
    """h = sLSTM(pre_x, r) from the zero state, with its gradient for
    pre_x and r (f32)."""

    @staticmethod
    def forward(ctx, pre_x, r):
        if pre_x.device.type == "cuda":
            out, saved = slstm_cell_cuda(pre_x.contiguous(), r.contiguous(),
                                         save=True)
        else:
            out, saved = slstm_cell_ref(pre_x, r, save=True)
        ctx.save_for_backward(out, saved, r)
        return out

    @staticmethod
    def backward(ctx, dout):
        out, saved, r = ctx.saved_tensors
        if out.device.type == "cuda":
            dpre = slstm_cell_bwd_cuda(saved, r, dout.contiguous())
        else:
            dpre = slstm_cell_bwd_ref(saved, r, dout)
        return dpre, recurrent_grad(out, dpre, r)


def slstm_cell(pre_x: torch.Tensor, r: torch.Tensor, initial_state=None,
               return_state: bool = False):
    """pre_x (C*B, H, S, 4, hd) pre-activations [z, i, f, o]; r (H, hd,
    4hd), or (C, H, hd, 4hd) for C clients of B rows; initial_state (c,
    n, m, h), each (C*B, H, hd) f32, or None (the zero state). Returns h
    (C*B, H, S, hd) in pre_x's dtype, and the final (c, n, m, h) with
    ``return_state``."""
    if pre_x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"slstm_cell runs on CUDA or the CPU, got {pre_x.device}")
    if torch.is_grad_enabled() and (pre_x.requires_grad or r.requires_grad):
        if initial_state is not None or return_state:
            raise NotImplementedError(
                "the sLSTM backward runs from the zero state and returns no "
                "state: a state's gradient is ROADMAP.md item 15c-2; got "
                f"initial_state {'given' if initial_state is not None else 'None'}"
                f", return_state={return_state}")
        if pre_x.dtype != torch.float32 or r.dtype != torch.float32:
            raise NotImplementedError(
                "the sLSTM backward takes float32 (the models cast pre_x and r "
                f"up, ROADMAP.md item 15c-1), got {pre_x.dtype}, {r.dtype}")
        return SLSTMCellFn.apply(pre_x, r)
    if pre_x.device.type == "cuda":
        state = (None if initial_state is None
                 else tuple(x.float().contiguous() for x in initial_state))
        return slstm_cell_cuda(pre_x.contiguous(), r.contiguous(),
                               initial_state=state, return_state=return_state)
    return slstm_cell_ref(pre_x, r, initial_state, return_state)
