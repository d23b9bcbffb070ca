"""Plain PyTorch version of the flash attention kernel.

The CPU path of ``ops.flash_attention`` and the oracle the CUDA kernel
is held against on the card. It follows the kernel, not the reference's
``src/repro/kernels/flash_attention/ref.py``, where the two differ: a
query row with no visible key (causal with Sq > Sk) gives 0, as the
TPU kernel's ``acc / max(l, 1e-30)`` does, where the reference's
softmax gives NaN.
"""
from __future__ import annotations

import torch

# Kernel vs plain version, as atol = rtol: f32 2e-5 (the online softmax
# rescales its sums tile by tile), bf16 2e-2 (the output is rounded to
# bf16); the tolerances of the reference's kernel tests.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def attention_scale(d: int) -> torch.Tensor:
    """1 / sqrt(d) rounded as the kernels round it: an f32 square root,
    then an f32 division."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d); Hq % Hkv == 0. Returns
    (B, Hq, Sq, d) in q's dtype, computed in f32. Queries are end-aligned
    to the keys; ``window > 0`` keeps each query's last ``window`` keys
    (itself included)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} K/V heads")
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * attention_scale(d)
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = ki <= qi
    if window > 0:
        mask = mask & (ki > qi - window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - safe_m), torch.zeros_like(s))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)
