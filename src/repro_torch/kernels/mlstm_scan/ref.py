"""Plain PyTorch version of the mLSTM scan kernel: the step-by-step
recurrence, as the reference's ``src/repro/kernels/mlstm_scan/ref.py``
(``gated_linear_scan_ref``).

The CPU path of ``ops.mlstm_scan`` and the oracle the CUDA kernel is
held against on the card, within ``mlstm_error_bound``.

``mlstm_scan_bwd_ref`` is the plain version of the backward kernel
(``mlstm_scan_bwd.cu``): the same recurrence differentiated step by
step, the CPU path of ``ops.MLSTMScanFn`` and the backward kernel's
oracle, within ``mlstm_grad_error_bound``.
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
# Backward kernel vs plain backward in f32: the same kind of reordered
# sums, one level deeper (each gradient is a sum over S of products that
# already carry the forward's rounding), and dlog_f a reverse cumulative
# sum over S of q.dq - k.dk, whose terms are the scale of the whole
# sequence's gradients: its row is the (b, h)'s S axis.
GRAD_ATOL, GRAD_ROW_RTOL = 1e-5, 1e-4


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


def _normalize_grads(dh, h, qn):
    """The normalize step's backward, h = u / max(|s|, 1) with s = q.n:
    (du, ds), as torch.abs and torch.clamp_min differentiate it (sign 0
    at s = 0, the whole gradient to |s| where |s| = 1)."""
    den = torch.clamp_min(torch.abs(qn), 1.0)
    du = dh / den[..., None]
    gate = torch.sign(qn) * (torch.abs(qn) >= 1.0).float()
    ds = -(dh * h).sum(-1) / den * gate
    return du, ds


def mlstm_scan_bwd_ref(q, k, v, log_f, dh, *, h=None, normalize: bool = True,
                       dq_scale: bool = False):
    """The gradient of ``mlstm_scan_ref(q, k, v, log_f, normalize=...)``
    for the output gradient dh (B, H, S, dv), step by step in f32. ``h``,
    where given, is the forward's output (B, H, S, dv), which the
    normalize step's backward reads (as the backward kernel does); else
    the recurrence's own. It matters: dq is a difference of two large
    terms (C du and n ds, whose sum vanishes as h is invariant to the
    scale of q wherever |q.n| >= 1), so an f32 difference in h moves it
    by many times its own size. The backward is: a
    forward sweep that keeps every state and gives dq, then the reverse
    recurrence of the state's gradient (G, g) for dC and dn:

        dq_t = C_t du_t + n_t ds_t
        G_t = q_t du_t^T + exp(lf_{t+1}) G_{t+1}   (g_t alike with ds_t)
        dk_t = G_t v_t + g_t ;  dv_t = G_t^T k_t
        dlf_t = exp(lf_t) (<G_t, C_{t-1}> + g_t . n_{t-1})

    where (du, ds) is the normalize step's backward (du = dh, ds = 0
    without it). Returns (dq, dk, dv, dlog_f) in f32, and with
    ``dq_scale`` also the magnitude of each dq row's two summands, the
    row's largest |C_t du_t| + |n_t ds_t| (B, H, S, 1): the scale of dq's
    rounding, for ``mlstm_grad_error_bound``."""
    b, nh, s, dk = q.shape
    dv = v.shape[-1]
    q, k, v, log_f, dh = (x.float() for x in (q, k, v, log_f, dh))
    h = None if h is None else h.float()
    dev = q.device
    c = torch.zeros((b, nh, dk, dv), dtype=torch.float32, device=dev)
    n = torch.zeros((b, nh, dk), dtype=torch.float32, device=dev)
    states, dus, dss, dqs, scales = [], [], [], [], []
    for t in range(s):
        states.append((c, n))
        decay = torch.exp(log_f[:, :, t])
        c = decay[..., None, None] * c + torch.einsum(
            "bhk,bhv->bhkv", k[:, :, t], v[:, :, t])
        n = decay[..., None] * n + k[:, :, t]
        if normalize:
            ht = torch.einsum("bhk,bhkv->bhv", q[:, :, t], c)
            qn = torch.einsum("bhk,bhk->bh", q[:, :, t], n)
            ht = ht / torch.clamp_min(torch.abs(qn), 1.0)[..., None]
            du, ds = _normalize_grads(dh[:, :, t], ht if h is None else h[:, :, t],
                                      qn)
        else:
            du, ds = dh[:, :, t], torch.zeros_like(dh[:, :, t, 0])
        dus.append(du)
        dss.append(ds)
        via_c, via_n = torch.einsum("bhkv,bhv->bhk", c, du), n * ds[..., None]
        dqs.append(via_c + via_n)
        scales.append((via_c.abs() + via_n.abs()).amax(-1))
    g_c = torch.zeros((b, nh, dk, dv), dtype=torch.float32, device=dev)
    g_n = torch.zeros((b, nh, dk), dtype=torch.float32, device=dev)
    dks, dvs, dlfs = [None] * s, [None] * s, [None] * s
    for t in reversed(range(s)):
        g_c = g_c + torch.einsum("bhk,bhv->bhkv", q[:, :, t], dus[t])
        g_n = g_n + q[:, :, t] * dss[t][..., None]
        dks[t] = torch.einsum("bhkv,bhv->bhk", g_c, v[:, :, t]) + g_n
        dvs[t] = torch.einsum("bhkv,bhk->bhv", g_c, k[:, :, t])
        c_prev, n_prev = states[t]
        decay = torch.exp(log_f[:, :, t])
        dlfs[t] = decay * ((g_c * c_prev).sum((-2, -1)) + (g_n * n_prev).sum(-1))
        g_c = decay[..., None, None] * g_c
        g_n = decay[..., None] * g_n
    if s == 0:
        grads = (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v),
                 torch.zeros_like(log_f))
        scale = torch.zeros_like(log_f)[..., None]
    else:
        grads = (torch.stack(dqs, 2), torch.stack(dks, 2), torch.stack(dvs, 2),
                 torch.stack(dlfs, 2))
        scale = torch.stack(scales, 2)[..., None]
    return (grads, scale) if dq_scale else grads


def mlstm_grad_error_bound(want: torch.Tensor, scale=None) -> torch.Tensor:
    """Elementwise bound on |got - want| between the backward kernel and
    the plain backward on the same f32 inputs: GRAD_ATOL + GRAD_ROW_RTOL
    times the row's scale: the largest |want| of the row, the last axis
    (dk or dv entries for dq, dk, dv; the S axis for dlog_f (B, H, S)),
    or ``scale`` where given, broadcast over the row. dq takes its
    summands' (``mlstm_scan_bwd_ref(..., dq_scale=True)``): with the
    normalizer, h is invariant to the scale of q_t wherever |q_t.n_t| >=
    1, so dq_t = C_t du_t + n_t ds_t is the difference of two terms that
    may be many times its size, and its rounding is theirs."""
    w = want.float().abs()
    if scale is None:
        scale = w.amax(dim=-1, keepdim=True) if w.numel() else w
    return (GRAD_ATOL + GRAD_ROW_RTOL * scale).expand_as(w)


def mlstm_error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| between the kernel and the plain
    version on the same f32 inputs, for h, C or n: ATOL + ROW_RTOL times
    the largest |want| of the row (the last axis)."""
    w = want.float().abs()
    scale = w.amax(dim=-1, keepdim=True) if w.numel() else w
    return (ATOL + ROW_RTOL * scale).expand_as(w)
