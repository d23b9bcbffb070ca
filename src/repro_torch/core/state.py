"""Round-state block registry: the single source of the state's block
layout (port of ``src/repro/core/state.py``).

A ``BlockSpec`` per top-level block of round state states which leaves
carry the leading client axis, how the block gathers and scatters under
the round's K-of-C ids, and how new client rows are filled when the
cohort grows:

- ``"all"``    every leaf has a leading client axis (models, last_round,
               sched): gather / scatter the whole tree by ids.
- ``"none"``   no leaf is per-client (server head, global models, the
               round counter): sampling passes through, scatter
               replaces wholesale.
- a tuple      only the named top-level sub-keys are stacked (opt
               moments vs. the shared ``step``; ``resid_up`` vs. the
               server-side ``resid_down``; ``c_local`` vs. ``c_global``
               and ``srv``): listed keys gather / scatter by ids, the
               rest replace wholesale.

The stacked leading-C axis is a *capacity*, not a membership count:
``grow`` pads every stacked leaf to a larger capacity (``capacity_for``
buckets of ``CAPACITY_BUCKET``), and who is active is the churn
scenario's mask (``repro_torch.data.scenario``); ``retire_clients``
resets departed slots to their fresh-join fill.

The integer leaves (``round``, ``last_round``, ``sched/last_round``,
``sched/part_count`` and the optimizers' ``step``) are int32, as the
reference's checkpoints hold them, so that each package restores the
other's round state.

Gathers use ``index_select``; a scatter returns new tensors
(``index_copy``), never writes into the state it was given, so a caller
may keep the state from before the scatter (torch tensors alias where
JAX arrays do not).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map

# Model groups of Algorithm 1: per-modality encoders f, unimodal heads
# g, and the multimodal fusion head g_M.
CLIENT_GROUPS = ("f_A", "g_A", "f_B", "g_B", "g_M")

# Optimizer-state trees that mirror the params (and therefore carry
# the leading client axis); everything else in an opt state (the shared
# ``step`` counter) is global.
OPT_MOMENT_KEYS = ("mu", "nu", "mom")

# Clients are padded to capacity buckets: capacity_for(17) ==
# capacity_for(24) == 24.
CAPACITY_BUCKET = 8


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One top-level round-state block.

    ``stacked``: "all" | "none" | tuple of stacked top-level sub-keys.
    ``fill``: the value new client rows take when the cohort grows: a
    scalar, ``"global"`` (new rows adopt the current global models), or
    a dict of per-sub-key scalars for "all" blocks whose sub-trees fill
    differently (``sched``).
    ``optional``: the block may be absent from a state (codec "none" and
    stateless strategies add no keys).
    """

    name: str
    stacked: object = "none"
    fill: object = 0.0
    optional: bool = False


REGISTRY: tuple[BlockSpec, ...] = (
    BlockSpec("models", "all", fill="global"),
    BlockSpec("server_gmv"),
    BlockSpec("global_models"),
    BlockSpec("opt", OPT_MOMENT_KEYS, fill=0.0),
    BlockSpec("srv_opt"),
    BlockSpec("last_round", "all", fill=-1),
    BlockSpec("round"),
    BlockSpec("sched", "all",
              fill={"omega_ema": 0.0, "part_count": 0, "last_round": -1}),
    BlockSpec("codec", ("resid_up",), fill=0.0, optional=True),
    BlockSpec("strat", ("c_local",), fill=0.0, optional=True),
)

BLOCKS = {b.name: b for b in REGISTRY}


def block(name: str) -> BlockSpec:
    try:
        return BLOCKS[name]
    except KeyError:
        raise KeyError(
            f"unregistered round-state block {name!r}: every top-level "
            f"state key must be declared in repro_torch.core.state.REGISTRY "
            f"(known: {sorted(BLOCKS)})"
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
    (full participation) is the identity; "none" blocks pass through;
    tuple blocks gather only their stacked sub-keys (sub-keys absent
    from ``value`` are skipped)."""
    spec = block(name)
    if idx is None or spec.stacked == "none":
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
    wholesale (full participation / global blocks); otherwise stacked
    leaves scatter the K rows to the sampled positions while a tuple
    block's unstacked sub-keys replace. Sub-keys absent from ``sub`` keep
    their previous value."""
    spec = block(name)
    if idx is None or spec.stacked == "none":
        return sub
    if spec.stacked == "all":
        return scatter_clients(full, sub, idx)
    out = dict(full)
    for k, v in sub.items():
        out[k] = scatter_clients(full[k], v, idx) if k in spec.stacked else v
    return out


def sample(state: dict, idx) -> dict:
    """Gather a whole round state down to the sampled rows, block by
    registered block (an unknown key raises)."""
    return {name: sample_block(name, value, idx)
            for name, value in state.items()}


def scatter(state: dict, updates: dict, idx) -> dict:
    """Write a round's per-block updates back into the full state; blocks
    absent from ``updates`` keep their previous value."""
    out = dict(state)
    for name, value in updates.items():
        out[name] = scatter_block(name, state.get(name), value, idx)
    return out


# ----------------------------------------------------- state construction --

def build_round_state(stacked, server_gmv, global_models, opt_state,
                      srv_opt_state, n_clients: int, codec_on: bool,
                      scfg) -> dict:
    """Assemble the round-state dict from its model and optimizer
    ingredients, the one place its block layout is spelled out (the
    reference's): codec "none" and stateless strategies add no keys."""
    from repro_torch.core import aggregate, schedule
    from repro_torch.core import codec as wire

    device = tree_leaves(global_models)[0].device
    state = {
        "models": stacked,
        "server_gmv": server_gmv,
        "global_models": global_models,
        "opt": opt_state,
        "srv_opt": srv_opt_state,
        "last_round": torch.full((n_clients,), -1, dtype=torch.int32,
                                 device=device),
        "round": torch.zeros((), dtype=torch.int32, device=device),
        "sched": schedule.sched_state(n_clients, device),
    }
    if codec_on:
        state["codec"] = {
            "resid_up": wire.zeros_like_tree(stacked),
            "resid_down": wire.zeros_like_tree(global_models),
        }
    if scfg is not None and scfg.stateful:
        state["strat"] = aggregate.init_state(
            scfg, {k: stacked[k] for k in CLIENT_GROUPS}, global_models)
    return state


# ------------------------------------------------------- elastic cohorts ---

def capacity_for(n_clients: int, bucket: int = CAPACITY_BUCKET) -> int:
    """Smallest capacity bucket holding ``n_clients`` slots."""
    if n_clients < 1:
        raise ValueError(f"n_clients={n_clients} must be >= 1")
    return bucket * ((n_clients + bucket - 1) // bucket)


def state_capacity(state: dict) -> int:
    """Client capacity C a round state was stacked for (the length of its
    ``last_round`` vector, present in every layout)."""
    return int(state["last_round"].shape[0])


def _fill_rows(like: torch.Tensor, n: int, fill) -> torch.Tensor:
    return torch.full((n,) + tuple(like.shape[1:]), fill, dtype=like.dtype,
                      device=like.device)


def _global_rows(globals_, value, n: int):
    """``n`` new model rows per group: the current global models."""
    return {k: tree_map(lambda x, g: g[None].expand(
        (n,) + tuple(g.shape)).to(x.dtype), value[k], globals_[k])
        for k in value}


def _per_block(state: dict, stacked_fn, global_fn):
    """Apply ``stacked_fn(tree, fill)`` to every stacked sub-tree of the
    state and ``global_fn(value)`` to every "global"-filled block."""
    out = {}
    for name, value in state.items():
        spec = block(name)
        if spec.stacked == "none":
            out[name] = value
        elif spec.stacked == "all":
            if spec.fill == "global":
                out[name] = global_fn(value)
            elif isinstance(spec.fill, dict):
                out[name] = {k: stacked_fn(v, spec.fill.get(k, 0))
                             for k, v in value.items()}
            else:
                out[name] = stacked_fn(value, spec.fill)
        else:
            out[name] = {k: (stacked_fn(v, spec.fill) if k in spec.stacked
                             else v) for k, v in value.items()}
    return out


def grow(state: dict, new_capacity: int) -> dict:
    """Re-stack every registered block to a larger capacity: existing rows
    are kept bit for bit, new rows take each block's declared fill
    (models adopt the current globals; moments, residuals and control
    variates start at zero; ``last_round`` at -1). Shrinking is refused:
    retire slots through the scenario's active mask instead."""
    old = state_capacity(state)
    if new_capacity < old:
        raise ValueError(
            f"cannot shrink round state in place: capacity {old} -> "
            f"{new_capacity}; retire clients via the scenario active mask")
    if new_capacity == old:
        return state
    n = new_capacity - old

    def pad(tree, fill):
        return tree_map(lambda x: torch.cat([x, _fill_rows(x, n, fill)]), tree)

    def globals_(value):
        rows = _global_rows(state["global_models"], value, n)
        return {k: tree_map(lambda x, r: torch.cat([x, r]), value[k], rows[k])
                for k in value}

    return _per_block(state, pad, globals_)


def retire_clients(state: dict, ids) -> dict:
    """Reset the given client slots to their fresh-join fill (models back
    to the current globals, moments / residuals / variates to zero,
    ``last_round`` to -1). The scenario's active mask keeps them from
    being sampled again; this keeps a departed client's private state out
    of later checkpoints. Returns new tensors."""
    n = len(np.asarray(ids).reshape(-1))

    def reset(tree, fill):
        return tree_map(lambda x: x.index_copy(0, _ids(ids, x.device),
                                               _fill_rows(x, n, fill)), tree)

    def globals_(value):
        rows = _global_rows(state["global_models"], value, n)
        return {k: tree_map(lambda x, r: x.index_copy(
            0, _ids(ids, x.device), r.contiguous()), value[k], rows[k])
            for k in value}

    return _per_block(state, reset, globals_)


# --------------------------------------------------- checkpoint inspection --

def manifest_capacity(manifest: dict) -> int:
    """Client capacity a checkpointed round state was stacked for, read
    off its ``last_round`` leaf."""
    try:
        return int(manifest["shapes"]["last_round"][0])
    except KeyError:
        raise KeyError(
            "checkpoint manifest has no 'last_round' leaf: not a "
            "round-state checkpoint") from None
