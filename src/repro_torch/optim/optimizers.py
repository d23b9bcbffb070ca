"""Minimal functional optimizers (AdamW, SGD) over parameter trees (port
of ``src/repro/optim/optimizers.py``).

An ``Optimizer`` is a pair of pure functions:
    init(params)                  -> opt_state
    update(grads, state, params)  -> (updates, new_state)
``apply_updates(params, updates)`` adds the updates to the params.

The state holds ONE int32 ``step`` for the whole tree and f32 moment
trees (``mu``/``nu`` for AdamW, ``mom`` for SGD with momentum).
``update`` updates nothing in place: every call returns new tensors, so
a caller may keep the old state (the round engine's masked update
does). This is why ``torch.optim`` is not used: it owns its state per
parameter and steps in place.

Both also have an in-place form, for a caller that owns its state (the
language models' train step, ``models/backbone.py``):
    update_(grads, state, params) -> (updates, state)
advances ``state``'s step and moments in place and overwrites each
f32 gradient leaf with its update (the returned updates ARE the
gradient tensors); ``apply_updates_(params, updates)`` adds them into
the params. A leaf's temporaries live only while that leaf is updated, so
the step holds no tree beyond the parameters, the moments and the
gradients; its results are those of ``update`` and ``apply_updates``
bit for bit (the same operations in the same order).
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
    update_: Callable[[Any, Any, Any], tuple] | None = None  # in place


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def apply_updates_(params, updates):
    """``apply_updates`` in place: each update added into its parameter.
    Returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates), strict=True):
        p.add_(u.to(p.dtype))
    return params


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

    def corrections(step):
        # bias corrections in f32, as the reference computes them
        return tuple(1 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                                device=step.device), step.float())
                     for b in (b1, b2))

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        bc1, bc2 = corrections(step)

        def u(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            return -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.float())

        return tree_map(u, mu, nu, params), {"step": step, "mu": mu, "nu": nu}

    def update_(grads, state, params):
        """``update`` in place, leaf by leaf: f32 gradient leaves become
        their updates. The same operations in the same order as
        ``update``: b1 m + (1 - b1) g (a product, then a sum: no fused
        ``add_(alpha=)``), then -lr_t (m^ / (sqrt(v^) + eps) + wd p)."""
        step = state["step"].add_(1)
        lr_t = lr(step) if callable(lr) else lr
        neg_lr = -lr_t
        bc1, bc2 = corrections(step)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(params),
                              strict=True):
            if g.dtype != torch.float32:
                raise ValueError(f"update_ writes the update into an f32 "
                                 f"gradient, got {g.dtype}")
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            den = torch.div(v, bc2).sqrt_().add_(eps)
            torch.div(m, bc1, out=g).div_(den)
            del den
            g.add_(weight_decay * p.float()).mul_(neg_lr)
        return grads, state

    return Optimizer(init=init, update=update, update_=update_)


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

    def update_(grads, state, params):
        """``update`` in place, leaf by leaf: f32 gradient leaves become
        their updates, with the same operations in the same order."""
        del params
        step = state["step"].add_(1)
        lr_t = lr(step) if callable(lr) else lr
        moms = tree_leaves(state["mom"]) if momentum else [None] * len(
            tree_leaves(grads))
        for g, m in zip(tree_leaves(grads), moms, strict=True):
            if g.dtype != torch.float32:
                raise ValueError(f"update_ writes the update into an f32 "
                                 f"gradient, got {g.dtype}")
            if m is not None:
                m.mul_(momentum).add_(g)
                g.copy_(m)
            g.mul_(-lr_t)
        return grads, state

    return Optimizer(init=init, update=update, update_=update_)
