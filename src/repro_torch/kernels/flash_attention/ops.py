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
and sliding-window masks, the logit cap, Sq != Sk) in f32 and in bf16.
In bf16 the forward is the bf16 kernel (its f32 log-sum-exp beside its
output) and the backward the f32 one on q, k, v, the output and its
gradient cast up to f32, its gradients cast back to bf16: the
reference's arithmetic, f32 inside and bf16 at the boundary. Other
dtypes are refused.
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


GRAD_DTYPES = (torch.float32, torch.bfloat16)  # what FlashAttentionFn takes


class FlashAttentionFn(torch.autograd.Function):
    """softmax(cap(q k^T / sqrt(d))) v over the visible keys, with its
    gradient for q, k and v (f32 or bf16, one dtype; K/V heads grouped,
    the window and the cap as in ``flash_attention``). Saves the inputs,
    the output and the f32 log-sum-exp; the backward computes in f32 and
    returns the inputs' dtype."""

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
        dtype = q.dtype
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                *(x.float().contiguous() for x in (q, k, v, out, dout)), lse,
                **ctx.form)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, dout, lse, **ctx.form)
        return dq.to(dtype), dk.to(dtype), dv.to(dtype), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d) -> (B, Hq, Sq, d)."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.dtype not in GRAD_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise NotImplementedError(
                f"the attention backward takes float32 or bfloat16 of one "
                f"dtype, got {q.dtype}, {k.dtype}, {v.dtype} (ROADMAP.md item "
                f"15c-1 trains in the reference's two compute dtypes)")
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
