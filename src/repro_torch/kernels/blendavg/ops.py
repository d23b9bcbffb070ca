"""Public wrapper: blend a tree (or flat array) of stacked client params.

``blend_params`` takes a ``(L, N)`` tensor or a tree whose leaves have
leading ``L``. On the card it blends every leaf of the tree in one
launch of the CUDA kernel (a tree of more than ``MAX_SEGMENTS`` leaves,
or of two dtypes, in one launch a group), where the JAX package launches
one Pallas call per leaf; each leaf's result is a tensor of its own.
Only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.blendavg.blendavg import blend_params_cuda, blend_tree_cuda
from repro_torch.kernels.blendavg.ref import blend_params_ref


def _cuda_tree(stacked, omega: torch.Tensor):
    leaves = [x.contiguous() for x in tree_leaves(stacked)]
    omega = omega.contiguous()
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) == 1:
        return tree_unflatten(stacked, blend_tree_cuda(leaves, omega))
    out = [None] * len(leaves)
    for dtype in dtypes:  # a launch a dtype
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        for i, o in zip(idx, blend_tree_cuda([leaves[i] for i in idx], omega)):
            out[i] = o
    return tree_unflatten(stacked, out)


def blend_params(stacked, omega: torch.Tensor):
    """stacked: (L, N) tensor OR tree whose leaves have leading dim L.
    omega (L,) masked blend weights (f32; on the leaves' device). Returns
    the blended tensor / tree."""
    if isinstance(stacked, torch.Tensor):
        if stacked.device.type == "cuda":
            return blend_params_cuda(stacked.contiguous(), omega.contiguous())
        if stacked.device.type == "cpu":
            return blend_params_ref(stacked, omega)
        raise ValueError(f"blend_params runs on CUDA or the CPU, got {stacked.device}")
    devs = {x.device.type for x in tree_leaves(stacked)}
    if devs == {"cuda"}:
        return _cuda_tree(stacked, omega)
    if devs == {"cpu"}:
        return tree_map(lambda x: blend_params_ref(
            x.reshape(x.shape[0], -1), omega).reshape(x.shape[1:]), stacked)
    raise ValueError(f"blend_params runs on CUDA or the CPU, got leaves on {devs}")
