"""Plain PyTorch version of the BlendAvg parameter-blend kernel.

The CPU path of ``ops.blend_params`` and the oracle the CUDA kernel is
held against on the card, with the tolerance ``blend_error_bound``
states.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bf16_ulp

EPS32 = float(torch.finfo(torch.float32).eps)


def blend_params_ref(stacked, omega):
    """stacked (L, N) client parameters; omega (L,) blend weights
    (already masked: discarded models carry omega=0). Returns (N,) f32-
    accumulated weighted sum cast back to the input dtype."""
    return (stacked.float() * omega.float()[:, None]).sum(0).to(stacked.dtype)


def blend_error_bound(stacked, omega, want, got):
    """Elementwise bound on |got - want| between two blends of the same
    inputs that sum the L f32 products in different orders (the kernel
    in l order, the plain version in PyTorch's reduction order):
    ``2 * L * eps32 * sum_l |omega_l * x_l|``. A bf16 result may then
    round to either neighbour, so bf16 adds one bf16 ulp of the larger
    of |want| and |got| (zero where both are zero)."""
    rows = stacked.shape[0]
    mag = (stacked.float().abs() * omega.float().abs()[:, None]).sum(0)
    bound = 2 * rows * EPS32 * mag
    if want.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(want.float().abs(),
                                               got.float().abs()))
    return bound
