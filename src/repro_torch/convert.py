"""Carry parameters and round state between the JAX package's numpy form
and the port.

``params_from_numpy`` takes either a nested numpy tree (what
``jax.tree.map(np.asarray, models)`` gives: dicts, with the MLP
encoder's ``hidden`` as a list) or the flat ``/``-keyed dict of a
checkpoint's ``arrays.npz`` (``hidden/0/w``, ...), and returns the
port's nested dict of tensors on ``device``. ``params_to_numpy`` is its
inverse, giving back the nested numpy tree. Both carry any tree of
arrays, lists and tuples kept as they are: stacked client models, global
models, wire-codec residuals, every language model's parameters and
decode caches (the hybrid's ``ssm`` (C, n) and the cross-attention
(k, v) are tuples, as in the reference).
``params_to_device`` also takes tensor leaves (initial weights given as
``base=``).

``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry an optimizer
state (``{"step", "mu"/"nu"/"mom": {group: tree}}``) and hold its
shared ``step`` to an int32 scalar; ``round_state_from_numpy`` /
``round_state_to_numpy`` carry a whole round state of the sharded round
(``federation_sharded.init_round_state``, every block) and hold its
counters (``ROUND_INT_LEAVES``) to int32, as both packages' checkpoints
keep them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import tree_map


def _unflatten(flat: dict):
    root: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"checkpoint key {key!r} nests under a leaf")
        if last in node:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        node[last] = leaf
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..n-1 (list indices in flattened paths) back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [node[k] for k in idx]
    return node


def _is_flat(tree) -> bool:
    return (isinstance(tree, dict) and any("/" in k for k in tree)
            and not any(isinstance(v, (dict, list, tuple)) for v in tree.values()))


def params_from_numpy(tree_or_flat, device):
    """Numpy parameters (nested tree or flat ``/``-keyed dict) -> nested
    dict of tensors on ``device``. Leaves are copied."""
    tree = _unflatten(tree_or_flat) if _is_flat(tree_or_flat) else tree_or_flat

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return conv(tree)


def params_to_device(tree, device):
    """``params_from_numpy`` for trees whose leaves may also be tensors
    (on any device): copies of the leaves on ``device``."""
    return params_from_numpy(tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
        tree), device)


def params_to_numpy(tree):
    """Nested dict of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def _check_step(step) -> None:
    if tuple(step.shape) != () or str(step.dtype).split(".")[-1] != "int32":
        raise ValueError(f"optimizer step must be an int32 scalar, got "
                         f"{step.dtype} of shape {tuple(step.shape)}")


def opt_state_from_numpy(state: dict, device) -> dict:
    """A numpy optimizer state -> the port's, on ``device``."""
    out = params_from_numpy(state, device)
    _check_step(out["step"])
    return out


def opt_state_to_numpy(state: dict) -> dict:
    """The port's optimizer state -> the same tree of numpy arrays."""
    _check_step(state["step"])
    return params_to_numpy(state)


# The round state's integer leaves: int32 in both packages.
ROUND_INT_LEAVES = ("round", "last_round", "sched/last_round",
                    "sched/part_count", "opt/step", "srv_opt/step")


def _check_round_ints(state: dict) -> None:
    for path in ROUND_INT_LEAVES:
        node = state
        for part in path.split("/"):
            node = node[part]
        if str(node.dtype).split(".")[-1] != "int32":
            raise ValueError(f"round-state leaf {path!r} must be int32, got "
                             f"{node.dtype}")


def round_state_from_numpy(state: dict, device) -> dict:
    """A numpy round state (``jax.tree.map(np.asarray, state)`` of the
    reference's) -> the port's, on ``device``."""
    out = params_from_numpy(state, device)
    _check_round_ints(out)
    return out


def round_state_to_numpy(state: dict) -> dict:
    """The port's round state -> the same tree of numpy arrays."""
    _check_round_ints(state)
    return params_to_numpy(state)
