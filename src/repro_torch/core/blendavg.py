"""BlendAvg — performance-weighted global aggregation (paper §III-B;
port of ``src/repro/core/blendavg.py``).

Given the previous global model and L candidate (locally trained) models:

1. score every candidate and the global model on the server's private
   representative validation set              (A_i, A_global)
2. Δ_i = A_i − A_global; discard Δ_i ≤ 0      (Eq. 9)
3. ω_i = Δ_i / Σ_{Δ_j>0} Δ_j                  (Eq. 10)
4. W_blended = Σ ω_i · W_i                    (Eq. 11)

If no candidate improves, the previous global model is kept unchanged.
Eq. 9-10 run in numpy float64 on the host, a copy of the reference's;
Eq. 11 runs through the blend kernel (``repro_torch.kernels.blendavg``)
with omega cast to float32 first, as the reference casts it.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_stack
from repro_torch.kernels.blendavg.ops import blend_params

# Async BlendAvg's omega damping exponent a in (1 + staleness)^-a (the
# reference's default).
STALENESS_EXP = 0.5


def blendavg_weights(scores: Sequence[float], global_score: float,
                     staleness: Sequence[float] | None = None,
                     staleness_exp: float = STALENESS_EXP) -> np.ndarray:
    """Eq. 9-10: masked, normalized improvement weights. Zero vector if no
    candidate improves on the global model.

    ``staleness`` (per-candidate, rounds since the candidate's base global
    model was current) damps improvements by (1 + s)^-``staleness_exp``
    before normalization — the async BlendAvg used for partial-
    participation rounds. Candidates that did not finish should arrive
    with score -inf (or NaN), masking them like any non-improver.

    A non-finite ``global_score`` is an ERROR, not a keep-global: a NaN
    score poisons every delta (masking all candidates forever), and a
    -inf score makes every delta +inf (NaN omegas after normalization).
    Both mean the server's scoring pass is broken — raise instead of
    silently freezing the federation on the last good global model.
    """
    global_score = float(global_score)
    if not np.isfinite(global_score):
        raise ValueError(
            f"blendavg_weights: global_score is {global_score} — the "
            "server's validation scoring is broken (a NaN score would "
            "silently mask every candidate, a -inf score would emit NaN "
            "omegas); refusing to aggregate")
    deltas = np.asarray(scores, np.float64) - global_score
    deltas = np.where(np.isnan(deltas), -np.inf, deltas)
    mask = deltas > 0
    if not mask.any():
        return np.zeros(len(deltas), np.float64)
    w = np.where(mask, deltas, 0.0)
    if staleness is not None and staleness_exp:
        s = np.maximum(np.asarray(staleness, np.float64), 0.0)
        w = w * (1.0 + s) ** (-staleness_exp)
    return w / w.sum()


def blend_trees(trees: Sequence, omega: np.ndarray):
    """Eq. 11 via the blend kernel over the stacked client models."""
    stacked = tree_stack(list(trees))
    dev = tree_leaves(stacked)[0].device
    return blend_params(stacked, torch.as_tensor(
        np.asarray(omega, np.float32), device=dev))


def blendavg(
    global_params,
    candidates: Sequence,
    eval_fn: Callable[[object], float],
    *,
    global_score: float | None = None,
):
    """Full BlendAvg step for one model group.

    eval_fn(params) -> validation score (higher is better, e.g. AUROC).
    Returns (blended_params, info dict).
    """
    if global_score is None:
        global_score = eval_fn(global_params)
    scores = [eval_fn(c) for c in candidates]
    omega = blendavg_weights(scores, global_score)
    if omega.sum() == 0:  # no improvement anywhere -> keep global model
        return global_params, {
            "scores": scores, "global_score": global_score,
            "omega": omega, "kept_global": True,
        }
    blended = blend_trees(candidates, omega)
    return blended, {
        "scores": scores, "global_score": global_score,
        "omega": omega, "kept_global": False,
    }


def fedavg(candidates: Sequence, n_samples: Sequence[int] | None = None):
    """FedAvg baseline: data-volume (or uniform) weighted average.

    All-zero ``n_samples`` is an error: no candidate holds data, so there
    is nothing to average — blending would silently return an all-zero
    model. Callers that can legitimately hit this (e.g. a zero-overlap
    federation) must keep the previous global model instead, exactly what
    ``engine.fedavg_update`` does with its explicit keep-global branch.
    """
    l = len(candidates)
    if n_samples is None:
        w = np.full(l, 1.0 / l)
    else:
        tot = float(sum(n_samples))
        if tot <= 0:
            raise ValueError(
                "fedavg: all candidate sample counts are zero — nothing to "
                "average; keep the previous global model instead (see "
                "engine.fedavg_update)")
        w = np.asarray(n_samples, np.float64) / tot
    return blend_trees(candidates, w)
