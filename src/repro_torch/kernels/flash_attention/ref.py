"""Plain PyTorch version of the flash attention kernel.

The CPU path of ``ops.flash_attention`` and the oracle the CUDA kernel
is held against on the card. It follows the kernel, not the reference's
``src/repro/kernels/flash_attention/ref.py``, where the two differ: a
query row with no visible key (causal with Sq > Sk) gives 0, as the
TPU kernel's ``acc / max(l, 1e-30)`` does, where the reference's
softmax gives NaN.

``flash_attention_bwd_ref`` is the plain backward (the CPU path of
``ops.FlashAttentionFn`` and the oracle of ``flash_attention_bwd.cu``,
within ``flash_grad_error_bound``): the gradients from the output, the
row log-sum-exp and the gradient of the output, as the kernel forms them,
for every form the forward takes (grouped K/V heads, causal and
sliding-window masks, the logit cap).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bf16_ulp

# Kernel vs plain version, as atol = rtol: f32 2e-5 (the online softmax
# rescales its sums tile by tile), bf16 2e-2 (the output is rounded to
# bf16); the tolerances of the reference's kernel tests.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# A bf16 instance of the kernel against the plain version on the same
# inputs (``bf16_error_bound``): the kernel forms the scores, the
# softmax and its sums in f32 as the plain version does, but rounds each
# probability p to bf16 for the P V product on the tensor cores (at most
# bf16's unit roundoff of p, 2^-8: 8 significant bits, to nearest), and
# each side sums its Sk terms in its own order (at most Sk f32 roundings
# of 2^-24 each, of the terms' scale).
P_RTOL_BF16 = 2.0 ** -8
# Backward kernel vs plain backward on the same inputs (f32): the products
# sum S or d terms in another order, and ds = p (dp - D) cancels; an
# element's error scales with the terms summed into it, so the absolute
# part is relative to the tensor's largest entry.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


def attention_scale(d: int) -> torch.Tensor:
    """1 / sqrt(d) rounded as the kernels round it: an f32 square root,
    then an f32 division."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def visible(sq: int, sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: the keys each query sees, queries end-aligned."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = ki <= qi
    if window > 0:
        mask = mask & (ki > qi - window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d); Hq % Hkv == 0. Returns
    (B, Hq, Sq, d) in q's dtype, computed in f32. Queries are end-aligned
    to the keys; ``window > 0`` keeps each query's last ``window`` keys
    (itself included); ``softcap > 0`` caps each scaled score s to
    softcap * tanh(s / softcap). With ``return_lse`` also the (B, Hq, Sq) f32
    log-sum-exp of each row's scaled scores (-inf with no visible key)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} K/V heads")
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * attention_scale(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = visible(sq, sk, causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - safe_m), torch.zeros_like(s))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if not return_lse:
        return out.to(q.dtype)
    lse = m + torch.log(p.sum(dim=-1, keepdim=True))
    lse = torch.where(torch.isfinite(m), lse, m)[..., 0]
    return out.to(q.dtype), lse


def bf16_error_bound(q, k, v, got, want, *, causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Elementwise bound on |got - want| between a bf16 instance of the
    kernel (``got``) and the plain version (``want``) on the same inputs:
    the terms summed into an output are p_j v_j, so its f32 value on
    either side lies within (P_RTOL_BF16 + 2 Sk 2^-24) sum_j p_j |v_j| of
    the other's (the plain softmax applied to |v|, in f32); each side
    then rounds to bf16, which may land on either neighbour: one bf16 ulp
    of the larger of |got| and |want|. The bound scales with each row's
    keys, not with a fixed tolerance, so it stays sensitive where a long
    row's outputs are small."""
    pv = flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                             window=window, softcap=softcap)
    sums = P_RTOL_BF16 + 2 * k.shape[2] * 2.0 ** -24
    return bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + sums * pv


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = False,
                            window: int = 0, softcap: float = 0.0):
    """The plain backward, f32: q, out, dout (B, Hq, Sq, d), k, v (B, Hkv,
    Sk, d) with Hq % Hkv == 0, lse (B, Hq, Sq) as the forward gives them;
    the forward's masks (queries end-aligned, ``window``) and logit cap.
    With s = (q . k) * scale, s_c = softcap * tanh(s / softcap) (s itself
    without a cap), p = exp(s_c - lse) on the visible keys and D =
    rowsum(dout o out): dv = p^T dout, ds = p (dout v^T - D) (times 1 -
    (s_c / softcap)^2 under a cap), dq = scale ds k, dk = scale ds^T q;
    dk and dv summed over the query heads of each K/V head. Returns (dq,
    dk, dv)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} K/V heads")
    group = hq // hkv
    scale = attention_scale(d)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = (visible(sq, sk, causal, window, q.device)
            & torch.isfinite(lse)[..., None])
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dout = dout.float()
    dv = p.transpose(-1, -2) @ dout
    dd = (dout * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dout @ vf.transpose(-1, -2) - dd)
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dk = ds.transpose(-1, -2) @ q.float() * scale

    def per_kv_head(x):  # (B, Hq, Sk, d) -> (B, Hkv, Sk, d)
        return x.reshape(b, hkv, group, sk, d).sum(dim=2)

    return ds @ kf * scale, per_kv_head(dk), per_kv_head(dv)


def flash_grad_error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| between the backward kernels and
    the plain backward on the same inputs (f32): GRAD_RTOL * |want| plus
    GRAD_ATOL_REL times the tensor's largest |want|."""
    want = want.float()
    return GRAD_RTOL * want.abs() + GRAD_ATOL_REL * want.abs().max()
