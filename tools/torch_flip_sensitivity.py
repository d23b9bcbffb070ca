#!/usr/bin/env python3
"""How far one validation AUROC pair ordered the other way moves BlendAvg's
omegas and the blended params, in the configuration of ``chip_smoke.py``
phase 22's card-vs-CPU runs (``card_vs_cpu``: smnist, 3 clients, d_hidden
48, 2 rounds), on the CPU.

    PYTHONPATH=src python3 tools/torch_flip_sensitivity.py

AUROC ranks the validation scores, so two runs whose scores differ only by
rounding give the same AUROC unless they order some (positive, negative)
pair differently; each such pair moves that label's term of the macro
AUROC by 1 / (L n_pos n_neg). For every Eq. 9-10 call of the run and every
candidate, the tool shifts the candidate's score by that step (the
smallest and the largest label's, up and down), recomputes the omegas
and, where the group blends, the blended params (sum of the omega change
times each candidate's leaves). Prints one JSON line a (encoder, data
seed): the step, and the smallest, median and largest move of the omegas
and of the params.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RUNS = [("transformer", 0), ("transformer", 2), ("recurrent", 0), ("recurrent", 2)]


def sensitivity(enc_type: str, data_seed: int) -> dict:
    import torch

    import repro_torch.core.federation as fed_mod
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.core.federation import FedConfig, Federation
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import make_task, train_val_test

    spec = make_task("smnist")
    tr, va, _ = train_val_test(spec, 500, 300, 300, seed=data_seed)
    cfg = FedConfig(n_clients=3, rounds=2, lr=1e-2, batch_size=64)
    clients = partition(tr, cfg.n_clients, frac_paired=0.4,
                        frac_fragmented=0.3, frac_partial=0.3)
    ecfg = EncoderConfig(d_hidden=48, n_layers=2, enc_type=enc_type)
    fed = Federation.init(torch.Generator().manual_seed(0), cfg, spec, ecfg,
                          clients, va, device="cpu")
    y = np.asarray(va.y)
    n_pos = y.sum(0)
    step = 1.0 / (y.shape[1] * n_pos * (len(y) - n_pos))  # one pair, a label
    weights, blend = fed_mod.blendavg_weights, fed.engine.fns.blend_stacked
    calls, blended = [], {}

    def recording(scores, global_score, **k):
        calls.append((np.asarray(scores, np.float64), float(global_score)))
        return weights(scores, global_score, **k)

    def keeping(stacked, omega):
        blended[len(calls) - 1] = [x.detach().double() for x in tree_leaves(stacked)]
        return blend(stacked, omega)

    fed_mod.blendavg_weights, fed.engine.fns.blend_stacked = recording, keeping
    try:
        for _ in range(cfg.rounds):
            fed.round()
    finally:
        fed_mod.blendavg_weights = weights
    d_omega, d_param = [], []
    for i, (scores, global_score) in enumerate(calls):
        omega = weights(scores, global_score)
        for k in range(len(scores)):
            for shift in (step.min(), -step.min(), step.max(), -step.max()):
                moved = scores.copy()
                moved[k] += shift
                d = weights(moved, global_score) - omega
                d_omega.append(float(np.abs(d).max()))
                if i in blended and omega.sum() > 0:
                    dt = torch.as_tensor(d, dtype=torch.float64)
                    d_param.append(max(float((x * dt.view(-1, *[1] * (x.dim() - 1)))
                                             .sum(0).abs().max()) for x in blended[i]))

    def spread(v):
        return ({"min": min(v), "median": float(np.median(v)), "max": max(v)}
                if v else None)

    return {"enc_type": enc_type, "data_seed": data_seed, "scoring_calls": len(calls),
            "auroc_step": [float(step.min()), float(step.max())],
            "omega_move": spread(d_omega), "param_move": spread(d_param)}


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(4)
    for enc_type, data_seed in RUNS:
        print(json.dumps(sensitivity(enc_type, data_seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
