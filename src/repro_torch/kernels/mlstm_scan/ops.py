"""Public wrapper of the mLSTM scan kernel.

``mlstm_scan(q, k, v, log_f)`` runs the chunkwise gated linear scan
from the zero state. A CUDA tensor goes through the CUDA kernel; only a
CPU tensor takes the plain version.

Where a gradient is wanted (autograd on, an input that requires it) the
call goes through ``MLSTMScanFn``: the forward kernel, then the backward
kernel (``mlstm_scan_bwd.cu``) or, for CPU tensors, the plain version
and the plain backward. That path computes in f32: bf16 inputs are cast
up before it, so autograd returns their gradients in bf16 (the
reference's scan computes in f32 from bf16 inputs too). It returns no
final state: a state's gradient is refused (ROADMAP item 15c-2), so no
call returns a tensor without a ``grad_fn`` while an input requires
grad; other input dtypes are refused.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_scan.mlstm_scan import mlstm_scan_cuda
from repro_torch.kernels.mlstm_scan.mlstm_scan_bwd import mlstm_scan_bwd_cuda
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_bwd_ref, mlstm_scan_ref


class MLSTMScanFn(torch.autograd.Function):
    """h = scan(q, k, v, log_f) from the zero state, with its gradient
    for all four (f32)."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, chunk, normalize):
        if q.device.type == "cuda":
            q, k, v, log_f = (x.contiguous() for x in (q, k, v, log_f))
            out = mlstm_scan_cuda(q, k, v, log_f, chunk=chunk, normalize=normalize)
        else:
            out = mlstm_scan_ref(q, k, v, log_f, normalize=normalize)
        ctx.normalize = normalize
        ctx.save_for_backward(q, k, v, log_f, out)
        return out

    @staticmethod
    def backward(ctx, dh):
        q, k, v, log_f, out = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = mlstm_scan_bwd_cuda(q, k, v, log_f, out, dh.contiguous(),
                                        normalize=ctx.normalize)
        else:
            grads = mlstm_scan_bwd_ref(q, k, v, log_f, dh, h=out,
                                       normalize=ctx.normalize)
        return (*grads, None, None)


def mlstm_scan(q, k, v, log_f, *, chunk: int = 64, normalize: bool = True,
               return_state: bool = False):
    """q, k (B, H, S, dk); v (B, H, S, dv); log_f (B, H, S), computed in
    f32. Returns h (B, H, S, dv) in f32, and the final (C, n) with
    ``return_state``."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mlstm_scan runs on CUDA or the CPU, got {q.device}")
    ins = (q, k, v, log_f)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        if return_state:
            raise NotImplementedError(
                "the mLSTM scan's backward returns no final state: a state's "
                "gradient is ROADMAP.md item 15c-2")
        if any(x.dtype not in (torch.float32, torch.bfloat16) for x in ins):
            raise NotImplementedError(
                "the mLSTM scan's backward takes float32 or bfloat16 inputs "
                "(ROADMAP.md item 15c-1 trains in the reference's two compute "
                f"dtypes), got {', '.join(str(x.dtype) for x in ins)}")
        return MLSTMScanFn.apply(*(x.float() for x in ins), chunk, normalize)
    if q.device.type == "cuda":
        return mlstm_scan_cuda(*(x.float().contiguous() for x in ins),
                               chunk=chunk, normalize=normalize,
                               return_state=return_state)
    return mlstm_scan_ref(q, k, v, log_f, normalize=normalize,
                          return_state=return_state)
