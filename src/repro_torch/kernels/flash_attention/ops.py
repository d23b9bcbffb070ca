"""Public wrapper of the flash attention kernel.

``flash_attention(q, k, v, causal=, window=)`` takes the interface of
the reference's ``flash_attention_pallas``: grouped-query heads, causal
and sliding-window masks, queries end-aligned to the keys. A CUDA tensor
goes through the CUDA kernel; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d) -> (B, Hq, Sq, d)."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on CUDA or the CPU, got {q.device}")
