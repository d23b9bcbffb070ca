"""Public wrapper of the sLSTM cell kernel.

``slstm_cell(pre_x, r)`` runs the stabilized sLSTM recurrence over the
whole sequence from the zero state, or from ``initial_state``, and with
``return_state`` also returns the final state. A CUDA tensor goes
through the CUDA kernel; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm_cell.ref import slstm_cell_ref
from repro_torch.kernels.slstm_cell.slstm_cell import slstm_cell_cuda


def slstm_cell(pre_x: torch.Tensor, r: torch.Tensor, initial_state=None,
               return_state: bool = False):
    """pre_x (B, H, S, 4, hd) pre-activations [z, i, f, o]; r (H, hd, 4hd);
    initial_state (c, n, m, h), each (B, H, hd) f32, or None (the zero
    state). Returns h (B, H, S, hd) in pre_x's dtype, and the final
    (c, n, m, h) with ``return_state``."""
    if pre_x.device.type == "cuda":
        state = (None if initial_state is None
                 else tuple(x.float().contiguous() for x in initial_state))
        return slstm_cell_cuda(pre_x.contiguous(), r.contiguous(),
                               initial_state=state, return_state=return_state)
    if pre_x.device.type == "cpu":
        return slstm_cell_ref(pre_x, r, initial_state, return_state)
    raise ValueError(f"slstm_cell runs on CUDA or the CPU, got {pre_x.device}")
