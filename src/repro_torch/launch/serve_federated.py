"""Serving driver: blended federation models behind the micro-batched
request engine, on one device (port of
``src/repro/launch/serve_federated.py``).

    # serve 3 request mixes off a small federation trained in-process
    PYTHONPATH=src python -m repro_torch.launch.serve_federated --train-rounds 6 \
        --requests 64 --mix all_multimodal --mix mixed_unimodal --mix vfl_heavy

    # serve a JAX train_federated checkpoint's blended global models and
    # VFL server head
    PYTHONPATH=src python -m repro_torch.launch.serve_federated \
        --ckpt-dir /tmp/fedckpt --requests 256 --mix vfl_heavy

    # smoke: 2 mixes through one engine, parity + byte assertions
    PYTHONPATH=src python -m repro_torch.launch.serve_federated --selftest

    # the recurrent (sLSTM) or transformer encoders, trained inline
    PYTHONPATH=src python -m repro_torch.launch.serve_federated --selftest \
        --enc-type recurrent --train-rounds 2

Requests route by available modalities to the blended local heads, pad
into capacity-bucketed micro-batches, and the VFL fallback's
feature/score messages meter real wire bytes through the codec. With no
checkpoint, a small BlendFL federation is trained inline
(``--train-rounds``, ``--clients``), as the reference does;
``--train-rounds 0`` serves models initialised from ``--seed`` instead.
Every ``--enc-type`` trains inline: the ``recurrent`` and ``transformer``
encoders' gradients run the sLSTM and flash attention backward kernels.
"""
from __future__ import annotations

import argparse
import time
import typing

import numpy as np
import torch

from repro_torch import resolve_device

# Request-mix presets: probability of (multimodal, A-only, B-only, vfl).
MIXES = {
    "all_multimodal": (1.0, 0.0, 0.0, 0.0),
    "mixed_unimodal": (0.0, 0.5, 0.5, 0.0),
    "vfl_heavy": (0.2, 0.1, 0.1, 0.6),
}

# Two runs of the same scores (engine vs single-request predict, card vs
# CPU, port vs reference) compute products of different shapes or on
# different devices, so rows agree to f32 rounding, not bit for bit.
# Under a lossy codec a last-ulp difference can also flip a codec
# decision of a row's wire message: an entry crosses the top-k threshold
# or an int8 rounding boundary. A flipped top-k decision on the score
# download drops or keeps a whole score (an error of up to 1), so no
# bound on the error itself holds. Where both runs recorded their wire
# messages (``codec.message_codes``), each large error must belong to a
# row whose messages differ, and such rows must stay rare. At d_hidden
# 1024 (256 int8 codes kept in each feature upload) the card ("NVIDIA
# H100 80GB HBM3", 700.00 W) and the CPU sent differing messages for
# 0.566% of the 1237 VFL rows of chip_smoke.py's fixed streams, and
# 0.63% of 289,345 rows over 154 random streams, 6 of which went above
# 1% (at most 1.10%; tools/torch_wire_flips.py, which reports the share
# and holds no cap). The recurrent (sLSTM) encoder's features, carried
# through 64 steps, agree less closely: card and CPU sent differing
# messages for 1.37% of the same fixed streams' 1237 rows (17 rows), so
# a card-vs-CPU run of that encoder is held to MAX_FLIPPED_RECURRENT.
ATOL_EXACT = 1e-5   # every score of a local route, or of a row whose messages agree
FRAC_LOSSY = 0.99   # a lossy run: this share of its scores within ATOL_EXACT
MAX_FLIPPED = 0.01  # ... and at most this share of its rows with differing messages
MAX_FLIPPED_RECURRENT = 0.03  # the same, card vs CPU on the recurrent encoder
ATOL_LOSSY = 2e-2   # a lossy run whose messages were not compared: every score


class Tolerance(typing.NamedTuple):
    ok: bool
    max_err: float   # largest absolute score error
    within: float    # share of scores within ATOL_EXACT
    flipped: float   # share of rows whose wire messages differ (0 if not compared)
    why: str         # what failed, or ""


def within_tolerance(errs, lossy: bool, flips=None,
                     max_flipped: float = MAX_FLIPPED) -> Tolerance:
    """Hold the absolute score errors of one run to the tolerance above.

    ``errs``: per-request arrays (rows, out_dim). ``flips``: per-request
    (rows,) bools, True where the row's wire messages differ between the
    two runs compared, or None when the messages were not compared.
    ``max_flipped``: the share of rows whose messages may differ.

    - not lossy: every score within ATOL_EXACT;
    - lossy, messages compared: every score of a row whose messages
      agree within ATOL_EXACT (so every larger error sits in a row whose
      messages differ), at most ``max_flipped`` of the rows with differing
      messages, and FRAC_LOSSY of the scores within ATOL_EXACT;
    - lossy, not compared: every score within ATOL_LOSSY and FRAC_LOSSY
      of them within ATOL_EXACT.

    A non-finite error (NaN or inf on either side) fails in every case.
    """
    errs = [np.asarray(e, np.float64).reshape(len(e), -1) for e in errs]
    flat = np.concatenate([e.ravel() for e in errs]) if errs else np.zeros(0)
    if not flat.size:
        return Tolerance(True, 0.0, 1.0, 0.0, "")
    max_err = float(flat.max())
    within = float((flat <= ATOL_EXACT).mean())
    if not np.isfinite(flat).all():
        return Tolerance(False, max_err, within, 0.0,
                         f"{int((~np.isfinite(flat)).sum())} non-finite score errors")
    if not lossy:
        ok = max_err <= ATOL_EXACT
        return Tolerance(ok, max_err, within, 0.0,
                         "" if ok else f"a score beyond {ATOL_EXACT}")
    why = "" if within >= FRAC_LOSSY else f"fewer than {FRAC_LOSSY} within {ATOL_EXACT}"
    if flips is None:
        if not max_err <= ATOL_LOSSY:
            why = why or f"a score beyond {ATOL_LOSSY}"
        return Tolerance(not why, max_err, within, 0.0, why)
    rows_err = np.concatenate([e.max(axis=1) for e in errs])
    flipped = np.concatenate([np.asarray(f, bool).ravel() for f in flips])
    if flipped.shape != rows_err.shape:
        raise ValueError(f"{flipped.size} message flags for {rows_err.size} rows")
    share = float(flipped.mean())
    unexplained = rows_err[~flipped]
    if not np.all(unexplained <= ATOL_EXACT):
        why = why or (f"a score beyond {ATOL_EXACT} ({unexplained.max():.3g}) "
                      "in a row whose wire messages agree")
    if share > max_flipped:
        why = why or f"{share:.4f} of the rows with differing messages"
    return Tolerance(not why, max_err, within, share, why)


def message_flips(codes_a, codes_b) -> np.ndarray:
    """(rows,) bools: rows whose recorded wire message codes differ."""
    return (codes_a.cpu() != codes_b.cpu()).any(dim=1).numpy()


def wire_diff(codes_a, codes_b, d_hidden: int) -> dict:
    """How one row's recorded wire messages differ between two sends
    (``PredictResult.wire`` / ``ServedResult.wire`` rows): for each of
    the h_A and h_B uploads and the score download, the entries kept by
    one send and dropped by the other ("kept set"), and the entries both
    kept with different int8 codes ("int8 code"). Empty when equal."""
    a, b = codes_a.cpu().long(), codes_b.cpu().long()
    out = {}
    for name, sl in (("h_A", slice(0, d_hidden)),
                     ("h_B", slice(d_hidden, 2 * d_hidden)),
                     ("scores", slice(2 * d_hidden, None))):
        x, y = a[sl], b[sl]
        kept = int(((x != 0) != (y != 0)).sum())
        code = int(((x != y) & (x != 0) & (y != 0)).sum())
        if kept or code:
            out[name] = {"kept set": kept, "int8 code": code}
    return out


def models_from_checkpoint(ckpt_dir: str, spec, ecfg, step: int | None = None,
                           device=None):
    """Blended ``global_models`` + VFL ``server_gmv`` out of a JAX
    ``train_federated`` round-state checkpoint, on ``device``.

    Reads just the two serving blocks (the stacked per-client models,
    optimizer moments and telemetry stay on disk), after a manifest
    preflight that checks the requested ``--d-hidden`` against the
    checkpoint's head shapes so a mismatch fails with dims, then checks
    every leaf's shape against the models this config builds.
    """
    from repro_torch.checkpoint import latest_step, load_arrays, read_manifest
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.encoders import fusion_init, init_client_models

    device = resolve_device(device)
    resolved = latest_step(ckpt_dir) if step is None else step
    if resolved is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    manifest = read_manifest(ckpt_dir, resolved)
    try:
        d_ck, out_ck = manifest["shapes"]["server_gmv/out/w"]
    except KeyError:
        raise KeyError(f"checkpoint {ckpt_dir} step {resolved} has no "
                       "server_gmv head — not a round-state checkpoint")
    if (d_ck, out_ck) != (ecfg.d_hidden, spec.out_dim):
        raise ValueError(
            f"checkpoint {ckpt_dir} step {resolved} was trained with "
            f"d_hidden={d_ck}, out_dim={out_ck}; this serving config asks "
            f"for d_hidden={ecfg.d_hidden}, out_dim={spec.out_dim} — fix "
            "--d-hidden/--task to match (see tools/ckpt_inspect.py)")
    flat = load_arrays(ckpt_dir, resolved,
                       prefixes=("global_models", "server_gmv"))
    gen = torch.Generator().manual_seed(0)
    template = {
        "global_models": init_client_models(gen, spec, ecfg, device="cpu"),
        "server_gmv": fusion_init(gen, ecfg.d_hidden, spec.out_dim,
                                  device="cpu"),
    }
    want = _flat_shapes(template)
    got = {k: tuple(v.shape) for k, v in flat.items()}
    for key, shape in want.items():
        if key not in got:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if got[key] != shape:
            raise ValueError(f"shape mismatch for {key!r}: {got[key]} vs {shape}")
    state = params_from_numpy({k: flat[k].astype(np.float32) for k in want},
                              device)
    print(f"restored blended models from {ckpt_dir} step {resolved}")
    return state["global_models"], state["server_gmv"]


def _flat_shapes(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_flat_shapes(v, f"{prefix}/{k}" if prefix else k))
    return out


def train_models(spec, ecfg, *, rounds: int, clients: int, seed: int,
                 device=None):
    """Small in-process BlendFL federation on ``device`` — enough
    training that the served models are blended artifacts, not random
    init. Returns (global_models, server_gmv)."""
    from repro_torch.core.federation import FedConfig, Federation
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import train_val_test

    tr, va, _ = train_val_test(spec, 240, 120, 60, seed=seed)
    parts = partition(tr, clients, seed=seed + 1)
    fcfg = FedConfig(n_clients=clients, rounds=rounds, batch_size=32,
                     seed=seed)
    fed = Federation.init(torch.Generator().manual_seed(seed), fcfg, spec,
                          ecfg, parts, va, device=device)
    fed.fit()
    print(f"trained in-process federation: {clients} clients, "
          f"{rounds} rounds on {fed.device}")
    return fed.global_models, fed.server_gmv


def make_requests(spec, mix: str, n: int, *, rows: int, seed: int,
                  salt: int | None = None) -> list:
    """A heterogeneous request stream for one mix preset. Row counts vary
    per request (1..rows) so the stream exercises multiple capacity
    buckets and the chunking path. By default the same numpy stream as
    the reference, seeded with ``hash(mix)``, which Python salts per
    process, so the two agree within one process only; an int ``salt``
    stands in for that hash, and the stream is then the same in every
    process."""
    from repro_torch.core.inference import InferenceRequest

    p_mm, p_a, p_b, p_vfl = MIXES[mix]
    rng = np.random.default_rng([seed, (hash(mix) if salt is None else salt)
                                 & 0xFFFF])
    kinds = rng.choice(4, size=n, p=[p_mm, p_a, p_b, p_vfl])
    out = []
    for kind in kinds:
        m = int(rng.integers(1, rows + 1))
        xa = rng.standard_normal((m, spec.seq_a, spec.feat_a)).astype(np.float32)
        xb = rng.standard_normal((m, spec.seq_b, spec.feat_b)).astype(np.float32)
        if kind == 1:
            out.append(InferenceRequest(xa, None))
        elif kind == 2:
            out.append(InferenceRequest(None, xb))
        else:
            out.append(InferenceRequest(xa, xb, vfl=(kind == 3)))
    return out


def serve_mix(engine, spec, mix: str, n: int, *, rows: int, seed: int,
              salt: int | None = None) -> dict:
    """Run one mix through the engine; per-mix latency/throughput/bytes."""
    reqs = make_requests(spec, mix, n, rows=rows, seed=seed, salt=salt)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    lat_ms = np.array([r.latency_s for r in results]) * 1e3
    total_rows = sum(len(r.scores) for r in results)
    return {
        "mix": mix, "requests": n, "rows": total_rows,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "rps": n / wall, "rows_per_s": total_rows / wall,
        "bytes_per_request": sum(r.bytes for r in results) / n,
        "wall_s": wall,
        "results": results,
    }


def build_engine(args, models, server_gmv, ecfg, kind, record_wire=False):
    from repro_torch.core.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(
        capacities=tuple(int(c) for c in args.capacities.split(",")),
        codec=args.codec, window=args.window, prefetch=args.prefetch,
        record_wire=record_wire)
    return ServingEngine(models, ecfg, kind, server_gmv=server_gmv, cfg=cfg,
                         device=args.device)


def load_models(args, spec, ecfg):
    """The served models: a checkpoint's when ``--ckpt-dir`` is given,
    else a federation trained inline for ``--train-rounds`` rounds, or,
    with ``--train-rounds 0``, models initialised from ``--seed``; all on
    ``--device``, for any ``--enc-type``."""
    from repro_torch.core.encoders import fusion_init, init_client_models

    if args.ckpt_dir:
        return models_from_checkpoint(args.ckpt_dir, spec, ecfg,
                                      step=args.step, device=args.device)
    if args.train_rounds > 0:
        return train_models(spec, ecfg, rounds=args.train_rounds,
                            clients=args.clients, seed=args.seed,
                            device=args.device)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    models = init_client_models(gen, spec, ecfg, device=device)
    gmv = fusion_init(gen, ecfg.d_hidden, spec.out_dim, device=device)
    print(f"serving models initialised from seed {args.seed} on {device}")
    return models, gmv


def selftest(args) -> None:
    """Smoke assertion: two different request mixes through ONE engine
    must (a) score every request like a single-request ``predict`` call,
    within the tolerance above, and (b) meter wire bytes that reconcile
    exactly with the analytic ``communication_cost``."""
    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.core.inference import predict
    from repro_torch.data.synthetic import make_task

    spec = make_task(args.task)
    ecfg = EncoderConfig(d_hidden=args.d_hidden, n_layers=args.n_layers,
                         enc_type=args.enc_type)
    models, gmv = load_models(args, spec, ecfg)
    engine = build_engine(args, models, gmv, ecfg, spec.kind,
                          record_wire=True)

    total_bytes = 0
    for mix in ("mixed_unimodal", "vfl_heavy"):
        reqs = make_requests(spec, mix, args.requests, rows=args.rows,
                             seed=args.seed)
        results = engine.run(reqs)
        if [r.index for r in results] != list(range(len(reqs))):
            raise AssertionError(f"results out of stream order ({mix})")
        errs = {False: [], True: []}  # lossy -> per-request abs errors
        flips = []  # lossy rows whose engine and predict messages differ
        for res, req in zip(results, reqs):
            ref = predict(models, req, ecfg, spec.kind, server_gmv=gmv,
                          codec=args.codec if req.vfl else None,
                          device=engine.device, record_wire=True)
            if res.route is not ref.route:
                raise AssertionError((res.route, ref.route))
            if res.scores.shape != ref.scores.shape:
                raise AssertionError((res.scores.shape, ref.scores.shape))
            lossy = req.vfl and args.codec != "none"
            errs[lossy].append((res.scores - ref.scores).abs().cpu().numpy())
            if lossy:
                flips.append(message_flips(res.wire, ref.wire))
        for lossy, e in errs.items():
            tol = within_tolerance(e, lossy, flips if lossy else None)
            if not tol.ok:
                raise AssertionError(
                    f"engine scores diverge from predict ({mix}, "
                    f"{'lossy' if lossy else 'exact'} routes): {tol.why}; max "
                    f"abs err {tol.max_err:.3g}, {tol.within:.4f} within "
                    f"{ATOL_EXACT}, {tol.flipped:.4f} of rows with differing "
                    "wire messages")
        total_bytes += sum(r.bytes for r in results)
        worst = max(float(np.max(e)) for es in errs.values() for e in es)
        print(f"selftest mix {mix}: {len(reqs)} requests match predict "
              f"(max abs err {worst:.3g})")
    if total_bytes != engine.stats["wire_bytes"]:
        raise AssertionError((total_bytes, engine.stats["wire_bytes"]))
    print(f"selftest ok: measured wire bytes {engine.stats['wire_bytes']} "
          "reconcile with analytic")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve a federation's blended models")
    ap.add_argument("--task", default="smnist")
    ap.add_argument("--ckpt-dir", default=None,
                    help="JAX train_federated checkpoint to serve from "
                         "(default: train a small federation in-process)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--train-rounds", type=int, default=6,
                    help="rounds of inline training (0: serve models "
                         "initialised from --seed)")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--d-hidden", type=int, default=32)
    ap.add_argument("--n-layers", type=int, default=1)
    ap.add_argument("--enc-type", default="mlp",
                    choices=("mlp", "recurrent", "transformer"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per mix")
    ap.add_argument("--rows", type=int, default=8,
                    help="max rows per request (row counts vary 1..rows)")
    ap.add_argument("--mix", action="append", default=None,
                    choices=sorted(MIXES), help="request mix preset "
                    "(repeatable; default: all three)")
    ap.add_argument("--capacities", default="2,4,16,64")
    ap.add_argument("--codec", default="none",
                    help="wire codec for the VFL fallback route")
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--selftest", action="store_true",
                    help="2 mixes + parity/bytes assertions, then exit")
    args = ap.parse_args(argv)

    if args.selftest:
        selftest(args)
        return

    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.data.synthetic import make_task

    spec = make_task(args.task)
    ecfg = EncoderConfig(d_hidden=args.d_hidden, n_layers=args.n_layers,
                         enc_type=args.enc_type)
    models, gmv = load_models(args, spec, ecfg)
    engine = build_engine(args, models, gmv, ecfg, spec.kind)

    for mix in (args.mix or sorted(MIXES)):
        row = serve_mix(engine, spec, mix, args.requests, rows=args.rows,
                        seed=args.seed)
        print(f"mix {mix:>15}: {row['requests']} req ({row['rows']} rows) "
              f"p50 {row['p50_ms']:.2f}ms p99 {row['p99_ms']:.2f}ms "
              f"{row['rps']:.1f} req/s {row['bytes_per_request']:.0f} B/req")
    st = engine.stats
    print(f"engine: {st['batches']} batches over routes "
          f"{ {k: v for k, v in st['batches_by_route'].items() if v} }; "
          f"wire {st['wire_messages']} msgs / {st['wire_bytes']} bytes; "
          f"build {st['build_seconds']:.3f}s stall {st['stall_seconds']:.3f}s "
          f"execute {st['execute_seconds']:.3f}s")


if __name__ == "__main__":
    main()
