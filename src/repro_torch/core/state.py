"""Round-state block registry and the K-of-C primitives (port of
``src/repro/core/state.py``).

A ``BlockSpec`` per block of round state that a sampled round gathers
states which leaves carry the leading client axis and so how the block
gathers and scatters under the round's ids:

- ``"all"``    every leaf has a leading client axis (the stacked
               models): gather / scatter the whole tree by ids.
- a tuple      only the named top-level sub-keys are stacked (opt
               moments vs. the shared ``step``; ``resid_up`` vs. the
               server-side ``resid_down``; ``c_local`` vs. ``c_global``
               and ``srv``): listed keys gather / scatter by ids, the
               rest replace wholesale.

The registry holds the blocks the port's ``Federation`` gathers, each as
the reference declares it; the reference's other blocks (global models,
counters, telemetry) stay host or global state here.

Gathers use ``index_select``; a scatter returns new tensors
(``index_copy``), never writes into the state it was given, so a caller
may keep the state from before the scatter (torch tensors alias where
JAX arrays do not).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_map

# Model groups of Algorithm 1: per-modality encoders f, unimodal heads
# g, and the multimodal fusion head g_M.
CLIENT_GROUPS = ("f_A", "g_A", "f_B", "g_B", "g_M")

# Optimizer-state trees that mirror the params (and therefore carry
# the leading client axis); everything else in an opt state (the shared
# ``step`` counter) is global.
OPT_MOMENT_KEYS = ("mu", "nu", "mom")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One round-state block: ``stacked`` is "all" or the tuple of its
    stacked top-level sub-keys."""

    name: str
    stacked: object


REGISTRY: tuple[BlockSpec, ...] = (
    BlockSpec("models", "all"),
    BlockSpec("opt", OPT_MOMENT_KEYS),
    BlockSpec("codec", ("resid_up",)),
    BlockSpec("strat", ("c_local",)),
)

BLOCKS = {b.name: b for b in REGISTRY}


def block(name: str) -> BlockSpec:
    try:
        return BLOCKS[name]
    except KeyError:
        raise KeyError(
            f"unregistered round-state block {name!r}: every block a "
            f"sampled round gathers must be declared in "
            f"repro_torch.core.state.REGISTRY (known: {sorted(BLOCKS)})"
        ) from None


# --------------------------------------------- K-of-C leaf primitives ------

def _ids(idx, device) -> torch.Tensor:
    """``idx`` (a sequence, numpy array or tensor of ids) as an int64
    tensor on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)


def sample_clients(stacked_tree, idx):
    """Gather the sampled clients' rows of every stacked leaf:
    (C, ...) -> (K, ...)."""
    return tree_map(lambda x: x.index_select(0, _ids(idx, x.device)),
                    stacked_tree)


def scatter_clients(stacked_tree, sub_tree, idx):
    """Inverse of ``sample_clients``: a new stacked tree with the K
    updated rows written at the sampled positions (cast to the full
    tree's dtype); ``stacked_tree`` itself is not written."""
    return tree_map(lambda full, s: full.index_copy(
        0, _ids(idx, full.device), s.to(full.dtype)), stacked_tree, sub_tree)


# ------------------------------------------------- block-level operations --

def sample_block(name: str, value, idx):
    """Gather one registered block down to the sampled rows. ``idx`` None
    (full participation) is the identity; tuple blocks gather only their
    stacked sub-keys (sub-keys absent from ``value`` are skipped)."""
    spec = block(name)
    if idx is None:
        return value
    if spec.stacked == "all":
        return sample_clients(value, idx)
    out = dict(value)
    for k in spec.stacked:
        if k in value:
            out[k] = sample_clients(value[k], idx)
    return out


def scatter_block(name: str, full, sub, idx):
    """Write one block's per-round update back. ``idx`` None replaces
    wholesale (full participation); otherwise stacked leaves scatter the
    K rows to the sampled positions while a tuple block's unstacked
    sub-keys replace. Sub-keys absent from ``sub`` keep their previous
    value."""
    spec = block(name)
    if idx is None:
        return sub
    if spec.stacked == "all":
        return scatter_clients(full, sub, idx)
    out = dict(full)
    for k, v in sub.items():
        out[k] = scatter_clients(full[k], v, idx) if k in spec.stacked else v
    return out
