"""Plain PyTorch version of the sLSTM cell kernel: a step loop, as the
reference's ``src/repro/kernels/slstm_cell/ref.py``.

The CPU path of ``ops.slstm_cell`` and the oracle the CUDA kernel is
held against on the card, within ``slstm_error_bound``; beside it the
plain backward, ``slstm_cell_bwd_ref`` (the CPU path of
``ops.SLSTMCellFn`` and the oracle of ``slstm_cell_bwd.cu``, within
``slstm_grad_error_bound``), and ``recurrent_grad``, the gradient of r
both paths form after their backward.

``r`` may stack C clients' weights, (C, H, hd, 4hd), over C*B rows of
``pre_x``, client-major, as the kernels take it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import bf16_ulp

# Kernel vs plain version in f32: the recurrent products sum their hd
# terms in another order, and the difference is carried through S steps.
ATOL, RTOL = 1e-5, 1e-4
# Backward kernel vs plain backward on the same inputs (f32): each step's
# recurrent gradient sums 4hd terms in another order, and BPTT carries the
# difference back through S steps into every earlier step. An element's
# error scales with the terms summed into it, not with its own size, so
# the absolute part is relative to the tensor's largest entry.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


def zero_state(b: int, h: int, hd: int, device) -> tuple:
    """(c, n, m, h) at the start of a sequence, each (B, H, hd) f32:
    zeros, with m = -1e30 so that the forget gate is exactly 0 at the
    first step."""
    zero = torch.zeros((b, h, hd), dtype=torch.float32, device=device)
    return zero, zero, zero - 1e30, zero


def _stacked(r, rows: int):
    """r as (C, H, hd, 4hd) f32 and the rows a client."""
    rf = r.float() if r.dim() == 4 else r.float()[None]
    return rf, rows // rf.shape[0]


def slstm_cell_ref(pre_x, r, initial_state=None, return_state: bool = False,
                   save: bool = False):
    """pre_x (C*B, H, S, 4, hd) pre-activations [z, i, f, o]; r (H, hd,
    4hd), or (C, H, hd, 4hd) for C clients; initial_state (c, n, m, h),
    each (C*B, H, hd) f32, or None for the zero state. Returns h (C*B, H,
    S, hd) in pre_x's dtype, computed in f32, then the final (c, n, m, h)
    with ``return_state``, then with ``save`` the (C*B, H, S, 7, hd) f32
    gate sums (z, i, f, o) and state (c, n, m) of every step, as the
    kernel saves them."""
    rows, h, s, _, hd = pre_x.shape
    rf, b = _stacked(r, rows)
    cl = rf.shape[0]
    if initial_state is None:
        initial_state = zero_state(rows, h, hd, pre_x.device)
    c, n, m, h_prev = (x.float() for x in initial_state)
    hs, saves = [], []
    for t in range(s):
        rec = (torch.einsum("bhi,hij->bhj", h_prev, rf[0]) if cl == 1 else
               torch.einsum("cbhi,chij->cbhj", h_prev.reshape(cl, b, h, hd),
                            rf)).reshape(rows, h, 4, hd)
        a = pre_x[:, :, t].float() + rec  # (C*B, H, 4, hd)
        z = torch.tanh(a[:, :, 0])
        log_i = a[:, :, 1]
        log_f = F.logsigmoid(a[:, :, 2])
        o = torch.sigmoid(a[:, :, 3])
        m_new = torch.maximum(log_f + m, log_i)
        i_g = torch.exp(log_i - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        m = m_new
        h_prev = o * c / torch.clamp_min(torch.abs(n), 1.0)
        hs.append(h_prev)
        if save:
            saves.append(torch.cat([a, torch.stack([c, n, m], dim=2)], dim=2))
    out = (torch.stack(hs, dim=2) if hs else
           pre_x.new_zeros((rows, h, 0, hd), dtype=torch.float32)).to(pre_x.dtype)
    extra = ((((c, n, m, h_prev),) if return_state else ())
             + ((torch.stack(saves, dim=2) if saves else pre_x.new_zeros(
                 (rows, h, 0, 7, hd), dtype=torch.float32),) if save else ()))
    return (out, *extra) if extra else out


def _tie_grad(a, b):
    """(d max(a, b) / da, d max(a, b) / db) as jnp.maximum takes them: 1
    to the larger, half each at a tie."""
    ga = torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))
    return ga, 1.0 - ga


def slstm_cell_bwd_ref(saved, r, dhs):
    """The plain backward: saved (C*B, H, S, 7, hd) as the forward saves
    it, r (H, hd, 4hd) or (C, H, hd, 4hd), dhs (C*B, H, S, hd) the
    gradient of h. Returns dpre (C*B, H, S, 4, hd) f32, the gradient of
    each step's gate sums (that of pre_x and of the recurrent product
    alike): an explicit reverse step loop, the adjoint of the forward's
    step including the path through the stabilizer m, with the gradient
    of max(|n|, 1) and of max(log_f + m, log_i) split half and half at a
    tie, as jnp.maximum's derivative splits it (at step 0, n = 1 exactly).
    ``torch.clamp_min`` would pass all of it at the tie instead."""
    rows, h, s, _, hd = saved.shape
    rf, b = _stacked(r, rows)
    cl = rf.shape[0]
    dpre = torch.zeros((rows, h, s, 4, hd), dtype=torch.float32,
                       device=saved.device)
    zero = torch.zeros((rows, h, hd), dtype=torch.float32, device=saved.device)
    dc, dn, dm, dh_rec = zero, zero, zero, zero
    for t in range(s - 1, -1, -1):
        sv = saved[:, :, t].float()
        a, (c1, n1, m1) = sv[:, :, :4], sv[:, :, 4:].unbind(2)
        if t > 0:
            c0, n0, m0 = saved[:, :, t - 1, 4:].float().unbind(2)
        else:
            c0, n0, m0 = zero_state(rows, h, hd, saved.device)[:3]
        z = torch.tanh(a[:, :, 0])
        log_i = a[:, :, 1]
        log_f = F.logsigmoid(a[:, :, 2])
        o = torch.sigmoid(a[:, :, 3])
        i_g = torch.exp(log_i - m1)
        f_g = torch.exp(log_f + m0 - m1)
        den = torch.clamp_min(torch.abs(n1), 1.0)
        dh = dhs[:, :, t].float() + dh_rec
        d_o = dh * c1 / den
        dct = dc + dh * o / den
        dden = -dh * o * c1 / (den * den)
        dnt = dn + dden * _tie_grad(torch.abs(n1), torch.ones_like(n1))[0]             * torch.sign(n1)
        df = dct * c0 + dnt * n0
        di = dct * z + dnt
        dz = dct * i_g
        dmt = dm - di * i_g - df * f_g
        g_f, g_i = _tie_grad(log_f + m0, log_i)
        dlog_i = di * i_g + dmt * g_i
        dlog_f = df * f_g + dmt * g_f
        dm = df * f_g + dmt * g_f
        da = torch.stack([dz * (1.0 - z * z), dlog_i,
                          dlog_f * torch.sigmoid(-a[:, :, 2]),
                          d_o * o * (1.0 - o)], dim=2)
        dpre[:, :, t] = da
        dc, dn = dct * f_g, dnt * f_g
        dh_rec = torch.einsum("cbhj,chij->cbhi", da.reshape(cl, b, h, 4 * hd),
                              rf).reshape(rows, h, hd)
    return dpre


def recurrent_grad(out, dpre, r):
    """The gradient of r: for each client and head, sum over its rows and
    steps of h_prev^T dpre (h_prev the previous step's output, 0 at step
    0), one batched product with the rows and steps as its contraction.
    out (C*B, H, S, hd), dpre (C*B, H, S, 4, hd); returns r's shape."""
    rows, h, s, hd = out.shape
    cl = r.shape[0] if r.dim() == 4 else 1
    b = rows // cl
    h_prev = F.pad(out[:, :, :-1].float(), (0, 0, 1, 0))
    lhs = h_prev.reshape(cl, b, h, s, hd).permute(0, 2, 4, 1, 3)
    rhs = dpre.reshape(cl, b, h, s, 4 * hd).permute(0, 2, 1, 3, 4)
    dr = torch.bmm(lhs.reshape(cl * h, hd, b * s),
                   rhs.reshape(cl * h, b * s, 4 * hd))
    return dr.reshape(r.shape).to(r.dtype)


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


def slstm_grad_error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| between the backward kernel and
    the plain backward on the same inputs (f32): GRAD_RTOL * |want| plus
    GRAD_ATOL_REL times the tensor's largest |want|."""
    want = want.float()
    return GRAD_RTOL * want.abs() + GRAD_ATOL_REL * want.abs().max()
