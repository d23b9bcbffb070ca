"""Minimal functional optimizers (AdamW, SGD) over parameter trees (port
of ``src/repro/optim/optimizers.py``).

An ``Optimizer`` is a pair of pure functions:
    init(params)                  -> opt_state
    update(grads, state, params)  -> (updates, new_state)
``apply_updates(params, updates)`` adds the updates to the params.

The state holds ONE int32 ``step`` for the whole tree and f32 moment
trees (``mu``/``nu`` for AdamW, ``mom`` for SGD with momentum). Nothing
is updated in place: every call returns new tensors, so a caller may
keep the old state (the round engine's masked update does). This is
why ``torch.optim`` is not used: it owns its state per parameter and
steps in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm_clip(grads, max_norm: float):
    """(grads scaled so that their global L2 norm is at most ``max_norm``,
    the norm before scaling), the norm summed in f32 leaf by leaf."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def _zeros_f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _step0(params):
    return torch.zeros([], dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """AdamW with decoupled weight decay. ``lr`` may be a schedule fn(step)."""

    def init(params):
        return {"step": _step0(params), "mu": _zeros_f32(params),
                "nu": _zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        # bias corrections in f32, as the reference computes them
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=step.device), step.float())
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=step.device), step.float())

        def u(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            return -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.float())

        return tree_map(u, mu, nu, params), {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "mom": _zeros_f32(params)}

    def update(grads, state, params):
        del params
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), {"step": step}
        mom = tree_map(lambda m, g: momentum * m + g.float(), state["mom"], grads)
        return tree_map(lambda m: -lr_t * m, mom), {"step": step, "mom": mom}

    return Optimizer(init=init, update=update)
