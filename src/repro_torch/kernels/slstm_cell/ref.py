"""Plain PyTorch version of the sLSTM cell kernel: a step loop, as the
reference's ``src/repro/kernels/slstm_cell/ref.py``.

The CPU path of ``ops.slstm_cell`` and the oracle the CUDA kernel is
held against on the card, within ``slstm_error_bound``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import bf16_ulp

# Kernel vs plain version in f32: the recurrent products sum their hd
# terms in another order, and the difference is carried through S steps.
ATOL, RTOL = 1e-5, 1e-4


def zero_state(b: int, h: int, hd: int, device) -> tuple:
    """(c, n, m, h) at the start of a sequence, each (B, H, hd) f32:
    zeros, with m = -1e30 so that the forget gate is exactly 0 at the
    first step."""
    zero = torch.zeros((b, h, hd), dtype=torch.float32, device=device)
    return zero, zero, zero - 1e30, zero


def slstm_cell_ref(pre_x, r, initial_state=None, return_state: bool = False):
    """pre_x (B, H, S, 4, hd) pre-activations [z, i, f, o]; r (H, hd, 4hd);
    initial_state (c, n, m, h), each (B, H, hd) f32, or None for the zero
    state. Returns h (B, H, S, hd) in pre_x's dtype, computed in f32, and
    the final (c, n, m, h) with ``return_state``."""
    b, h, s, _, hd = pre_x.shape
    rf = r.float()
    if initial_state is None:
        initial_state = zero_state(b, h, hd, pre_x.device)
    c, n, m, h_prev = (x.float() for x in initial_state)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhi,hij->bhj", h_prev, rf).reshape(b, h, 4, hd)
        pre = pre_x[:, :, t].float()  # (B, H, 4, hd)
        z = torch.tanh(pre[:, :, 0] + rec[:, :, 0])
        log_i = pre[:, :, 1] + rec[:, :, 1]
        log_f = F.logsigmoid(pre[:, :, 2] + rec[:, :, 2])
        o = torch.sigmoid(pre[:, :, 3] + rec[:, :, 3])
        m_new = torch.maximum(log_f + m, log_i)
        i_g = torch.exp(log_i - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        m = m_new
        h_prev = o * c / torch.clamp_min(torch.abs(n), 1.0)
        hs.append(h_prev)
    out = (torch.stack(hs, dim=2) if hs else
           pre_x.new_zeros((b, h, 0, hd), dtype=torch.float32)).to(pre_x.dtype)
    return (out, (c, n, m, h_prev)) if return_state else out


def slstm_error_bound(want: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| between the kernel and the plain
    version on the same inputs: ATOL + RTOL * |want|; a bf16 output may
    then round to either neighbour, so bf16 adds one bf16 ulp of the
    larger of |want| and |got|."""
    bound = ATOL + RTOL * want.float().abs()
    if want.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(want.float().abs(),
                                               got.float().abs()))
    return bound
