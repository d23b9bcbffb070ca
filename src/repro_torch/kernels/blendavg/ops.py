"""Public wrapper: blend a tree (or flat array) of stacked client params.

``blend_params`` takes a ``(L, N)`` tensor or a tree whose leaves have
leading ``L``, and blends each leaf with one launch of the CUDA kernel,
as the JAX package launches one Pallas call per leaf. A CUDA tensor goes
through the kernel; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.common.tree import tree_map
from repro_torch.kernels.blendavg.blendavg import blend_params_cuda
from repro_torch.kernels.blendavg.ref import blend_params_ref


def _blend_2d(stacked: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    if stacked.device.type == "cuda":
        return blend_params_cuda(stacked.contiguous(), omega.contiguous())
    if stacked.device.type == "cpu":
        return blend_params_ref(stacked, omega)
    raise ValueError(f"blend_params runs on CUDA or the CPU, got {stacked.device}")


def blend_params(stacked, omega: torch.Tensor):
    """stacked: (L, N) tensor OR tree whose leaves have leading dim L.
    omega (L,) masked blend weights (f32; on the leaves' device). Returns
    the blended tensor / tree."""
    if isinstance(stacked, torch.Tensor):
        return _blend_2d(stacked, omega)

    def leaf(x):
        return _blend_2d(x.reshape(x.shape[0], -1), omega).reshape(x.shape[1:])

    return tree_map(leaf, stacked)
