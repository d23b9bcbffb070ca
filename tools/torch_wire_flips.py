#!/usr/bin/env python3
"""Count the VFL rows whose wire messages differ between a CUDA card and
the CPU, on the PyTorch port's full-width serving model.

    python3 tools/torch_wire_flips.py --seconds 400

Serves the model of ``chip_smoke.py`` phase 4 (MLP encoders, d_hidden
1024, 4 layers, 64x128 features a modality, 25 labels, random weights
from seed 0) on fresh ``vfl_heavy`` streams (seeds 0, 1, ...; each of
``--requests`` requests of 1..64 rows) through a ``ServingEngine`` that
records each row's wire messages (``int8_topk`` codec), scores every
VFL request again on the CPU, and holds them to each other as
``serve_federated.within_tolerance`` does. It stops starting streams
after ``--seconds`` and prints one JSON line: rows, rows whose messages
differ (overall and per stream), the kinds of difference (which
message; a kept-set or an int8-code difference), every row whose score
error exceeds ATOL_LOSSY, and the count of scores beyond ATOL_EXACT in
rows whose messages agree (which the check requires to be 0). Needs
one CUDA card; run from the repository root.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--requests", type=int, default=96)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_wire_flips: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import encoders as enc
    from repro_torch.core.inference import predict
    from repro_torch.core.serving import ServingConfig, ServingEngine
    from repro_torch.data.synthetic import TaskSpec
    from repro_torch.launch import serve_federated as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    spec = TaskSpec("blendfl-1024", "multilabel", 25, 64, 128, 64, 128)
    ecfg = enc.EncoderConfig(d_hidden=1024, n_layers=4, enc_type="mlp")
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = enc.init_client_models(gen, spec, ecfg, device="cuda")
    gmv = enc.fusion_init(gen, ecfg.d_hidden, spec.out_dim, device="cuda")
    cpu_models = params_from_numpy(params_to_numpy(models), "cpu")
    cpu_gmv = params_from_numpy(params_to_numpy(gmv), "cpu")
    engine = ServingEngine(models, ecfg, spec.kind, server_gmv=gmv, device="cuda",
                           cfg=ServingConfig(codec="int8_topk",
                                             capacities=(2, 4, 16, 64),
                                             record_wire=True))

    kinds: dict = {}
    big, shares = [], []
    rows = flipped = unexplained = 0
    t0 = time.perf_counter()
    seed = 0
    while time.perf_counter() - t0 < args.seconds:
        reqs = [q for q in sf.make_requests(spec, "vfl_heavy", args.requests,
                                            rows=64, seed=seed, salt=303) if q.vfl]
        n_rows = n_flipped = 0
        for res, req in zip(engine.run(reqs), reqs):
            want = predict(cpu_models, req, ecfg, spec.kind, server_gmv=cpu_gmv,
                           codec="int8_topk", device="cpu", record_wire=True)
            err = (res.scores.cpu() - want.scores).abs().numpy()
            flips = sf.message_flips(res.wire, want.wire)
            unexplained += int((err[~flips] > sf.ATOL_EXACT).sum())
            n_rows += len(flips)
            n_flipped += int(flips.sum())
            for i in np.flatnonzero(flips):
                diff = sf.wire_diff(res.wire[i], want.wire[i], ecfg.d_hidden)
                key = " ".join(f"{m}:{'kept set' if d['kept set'] else 'int8 code'}"
                               for m, d in sorted(diff.items()))
                kinds[key] = kinds.get(key, 0) + 1
                if err[i].max() > sf.ATOL_LOSSY:
                    big.append({"seed": seed, "err": float(err[i].max()), "diff": diff})
        rows += n_rows
        flipped += n_flipped
        shares.append(n_flipped / n_rows)
        seed += 1
    shares = np.asarray(shares)
    print(json.dumps({
        "device": smi, "streams": seed, "rows": rows, "rows_differing": flipped,
        "share": flipped / rows,
        "share_per_stream": {"min": float(shares.min()),
                             "median": float(np.median(shares)),
                             "max": float(shares.max())},
        "streams_above_max_flipped": int((shares > sf.MAX_FLIPPED).sum()),
        "kinds": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "rows_beyond_atol_lossy": big,
        "unexplained_scores": unexplained,
    }))
    return 0 if unexplained == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
