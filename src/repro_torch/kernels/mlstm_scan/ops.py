"""Public wrapper of the mLSTM scan kernel.

``mlstm_scan(q, k, v, log_f)`` runs the chunkwise gated linear scan
from the zero state. A CUDA tensor goes through the CUDA kernel; only a
CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_scan.mlstm_scan import mlstm_scan_cuda
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref


def mlstm_scan(q, k, v, log_f, *, chunk: int = 64, normalize: bool = True,
               return_state: bool = False):
    """q, k (B, H, S, dk); v (B, H, S, dv); log_f (B, H, S), computed in
    f32. Returns h (B, H, S, dv) in f32, and the final (C, n) with
    ``return_state``."""
    if q.device.type == "cuda":
        return mlstm_scan_cuda(*(x.float().contiguous() for x in (q, k, v, log_f)),
                               chunk=chunk, normalize=normalize,
                               return_state=return_state)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, log_f, normalize=normalize,
                              return_state=return_state)
    raise ValueError(f"mlstm_scan runs on CUDA or the CPU, got {q.device}")
