"""Public wrapper of the sLSTM cell kernel.

``slstm_cell(pre_x, r)`` runs the stabilized sLSTM recurrence over the
whole sequence from a zero state. A CUDA tensor goes through the CUDA
kernel; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm_cell.ref import slstm_cell_ref
from repro_torch.kernels.slstm_cell.slstm_cell import slstm_cell_cuda


def slstm_cell(pre_x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """pre_x (B, H, S, 4, hd) pre-activations [z, i, f, o]; r (H, hd, 4hd).
    Returns h (B, H, S, hd) in pre_x's dtype."""
    if pre_x.device.type == "cuda":
        return slstm_cell_cuda(pre_x.contiguous(), r.contiguous())
    if pre_x.device.type == "cpu":
        return slstm_cell_ref(pre_x, r)
    raise ValueError(f"slstm_cell runs on CUDA or the CPU, got {pre_x.device}")
