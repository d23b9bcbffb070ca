"""Public wrapper of the flash attention kernel.

``flash_attention(q, k, v, causal=, window=, softcap=)`` takes the
interface of the reference's ``flash_attention_pallas``: grouped-query
heads, causal and sliding-window masks, queries end-aligned to the keys;
``softcap`` is the language models' logit cap (``attn_logit_softcap``). A CUDA tensor
goes through the CUDA kernel; only a CPU tensor takes the plain version.

Where a gradient is wanted (autograd on, an input that requires it) the
call goes through ``FlashAttentionFn``: the forward also keeps each
row's log-sum-exp, and the backward runs the CUDA backward kernels
(``flash_attention_bwd.cu``) or, for CPU tensors, the plain backward.
That path takes every form the forward takes (grouped K/V heads, causal
and sliding-window masks, the logit cap, Sq != Sk) in f32; other dtypes
are refused (ROADMAP item 15c: bf16 and stateful gradients).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd_cuda,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)


class FlashAttentionFn(torch.autograd.Function):
    """softmax(cap(q k^T / sqrt(d))) v over the visible keys, with its
    gradient for q, k and v (f32; K/V heads grouped, the window and the
    cap as in ``flash_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        if q.device.type == "cuda":
            out, lse = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=causal,
                                            window=window, softcap=softcap,
                                            return_lse=True)
        else:
            out, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                           softcap=softcap, return_lse=True)
        ctx.form = dict(causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if q.device.type == "cuda"
               else flash_attention_bwd_ref)
        dq, dk, dv = bwd(q, k, v, out, dout, lse, **ctx.form)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d) -> (B, Hq, Sq, d)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if any(x.dtype != torch.float32 for x in (q, k, v)):
            raise NotImplementedError(
                f"the attention backward takes float32, got {q.dtype}, "
                f"{k.dtype}, {v.dtype} (ROADMAP.md item 15c: bf16 and stateful "
                f"gradients)")
        return FlashAttentionFn.apply(q, k, v, bool(causal), max(int(window), 0),
                                      float(softcap))
    if q.device.type == "cuda":
        # K/V where they lie (a decode cache read in place); copies only
        # where the head dim is not contiguous or the two strides differ
        if k.stride(-1) != 1 or v.stride() != k.stride():
            k, v = k.contiguous(), v.contiguous()
        return flash_attention_cuda(q.contiguous(), k, v, causal=causal,
                                    window=window, softcap=softcap)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)
