"""Plain PyTorch version of the mLSTM scan kernel: the step-by-step
recurrence, as the reference's ``src/repro/kernels/mlstm_scan/ref.py``
(``gated_linear_scan_ref``).

The CPU path of ``ops.mlstm_scan`` and the oracle the CUDA kernel is
held against on the card, within ``mlstm_error_bound``.
"""
from __future__ import annotations

import torch

# Kernel vs plain version in f32. The kernel sums each dot product (dk
# terms for q.k and q.C, L terms for the in-chunk sums) in another order,
# and factors the decay once per chunk (exp(d_i) (q.C), exp(D - d_j) k_j)
# where the recurrence multiplies it in at every step. The rounding of
# such a sum scales with the magnitude of its terms, which is the scale
# of the whole row (the dv entries of h or C, the dk entries of n), not
# of each entry: a small entry may be the difference of large terms.
ATOL, ROW_RTOL = 1e-5, 1e-4


def mlstm_scan_ref(q, k, v, log_f, *, normalize: bool = True,
                   return_state: bool = False):
    """q, k (B, H, S, dk); v (B, H, S, dv); log_f (B, H, S). Step by step
    from the zero state, in f32:

        C_t = exp(lf_t) C_{t-1} + k_t v_t^T ;  n_t = exp(lf_t) n_{t-1} + k_t
        h_t = q_t C_t [/ max(|q_t.n_t|, 1)]

    Returns h (B, H, S, dv) in f32, and the final (C (B, H, dk, dv),
    n (B, H, dk)) with ``return_state``."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    q, k, v, log_f = q.float(), k.float(), v.float(), log_f.float()
    c = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(s):
        decay = torch.exp(log_f[:, :, t])
        c = decay[..., None, None] * c + torch.einsum(
            "bhk,bhv->bhkv", k[:, :, t], v[:, :, t])
        n = decay[..., None] * n + k[:, :, t]
        ht = torch.einsum("bhk,bhkv->bhv", q[:, :, t], c)
        if normalize:
            qn = torch.einsum("bhk,bhk->bh", q[:, :, t], n)
            ht = ht / torch.clamp_min(torch.abs(qn), 1.0)[..., None]
        hs.append(ht)
    out = (torch.stack(hs, dim=2) if hs else
           torch.zeros((b, h, 0, dv), dtype=torch.float32, device=q.device))
    return (out, (c, n)) if return_state else out


def mlstm_error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| between the kernel and the plain
    version on the same f32 inputs, for h, C or n: ATOL + ROW_RTOL times
    the largest |want| of the row (the last axis)."""
    w = want.float().abs()
    scale = w.amax(dim=-1, keepdim=True) if w.numel() else w
    return (ATOL + ROW_RTOL * scale).expand_as(w)
