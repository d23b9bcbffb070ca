"""One-card dry run: size every (architecture x input shape) entry on the
meta device, and with ``--run`` build and time it on the card (the
port's counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each entry on 512 placeholder TPU devices).

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all            # 40 records, meta only
    python -m repro_torch.launch.dryrun --all --run      # each entry that fits, on the card
    python -m repro_torch.launch.dryrun --blendfl        # the federated round

(with ``PYTHONPATH=src`` from the repository root). Each record holds
the entry's one-card share (one data shard's rows, ``specs.
one_card_shape``; ``--multi-pod`` takes the 32-shard share), its
parameter count and bytes, its argument bytes (parameters, cache,
batch), the bytes it holds at once (arguments and, for prefill, the
cache it returns) against the card's 80 GB, and the roofline row
(``launch/roofline.py``). Status: ``ok``, ``skip`` (the reference's
skips) or ``does_not_fit`` (with the bytes); ``fail`` only if sizing
raised. ``--run`` runs each fitting prefill / decode entry on the card
once to warm up, then times one call between ``torch.cuda.synchronize``
calls and records the peak memory (``time_entry``, the routine
``chip_smoke.py`` times its production entries with); a train entry is
ROADMAP item 15c and is sized only.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as SP
from repro_torch.models import backbone as bb


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def size_entry(cfg, shape) -> dict:
    """Meta-device sizing of ``cfg`` at ``shape`` (a one-card share):
    parameter count and bytes, argument bytes, the bytes held at once
    and the roofline row."""
    params = SP.params_specs(cfg)
    p_bytes = nbytes(params)
    rec = {"n_params": sum(x.numel() for x in tree_leaves(params)),
           "param_bytes": p_bytes}
    if shape.kind == "train":
        batch = SP.train_batch_specs(cfg, shape)
        # AdamW's two f32 moments a parameter and its step
        arg_bytes = p_bytes + 2 * 4 * rec["n_params"] + 4 + nbytes(batch)
        out_bytes = 0
    elif shape.kind == "prefill":
        batch = SP.prefill_batch_specs(cfg, shape)
        arg_bytes = p_bytes + nbytes(batch)
        cache = bb.init_cache(cfg, shape.batch, shape.seq, torch.bfloat16,
                              enc_len=SP.ENC_FRAMES, device="meta")
        out_bytes = nbytes(cache) + 2 * shape.batch * cfg.vocab_size
        rec["cache_bytes"] = nbytes(cache)
    else:
        d = SP.decode_specs(cfg, shape)
        rec["cache_bytes"] = nbytes(d["cache"])
        arg_bytes = p_bytes + nbytes(d)
        out_bytes = 2 * shape.batch * cfg.vocab_size  # the cache is updated
    rec["arg_bytes"] = arg_bytes
    rec["held_bytes"] = arg_bytes + out_bytes
    rec["card_share"] = rec["held_bytes"] / rl.CARD_BYTES
    rec["roofline"] = rl.roofline(cfg, shape, params, arg_bytes + out_bytes,
                                  enc_len=SP.ENC_FRAMES).row()
    return rec


def materialize(cfg, shape, device, *, seed: int = 0, params=None):
    """Real arguments of ``specs.make_entry(cfg, shape)``'s function on
    ``device``, from ``seed``: random parameters (unless given), random
    tokens and patches or frames; for decode a bf16 cache of random
    normal K/V (the reference's decode entry takes its cache as an
    argument; recurrent states, f32, start at zero) at index seq - 1.
    Returns the argument tuple."""
    rng = np.random.default_rng(seed)
    if params is None:
        params = bb.init_params(torch.Generator(device=device).manual_seed(seed),
                                cfg, device=device)

    def fill(spec):
        if spec.dtype == torch.int32:
            hi = cfg.vocab_size if spec.dim() == 2 else 1
            return torch.from_numpy(rng.integers(0, hi, tuple(spec.shape))
                                    .astype(np.int32)).to(device)
        return torch.from_numpy(rng.standard_normal(tuple(spec.shape))
                                .astype(np.float32)).to(device, spec.dtype)

    if shape.kind == "prefill":
        return params, {k: fill(v) for k, v in SP.prefill_batch_specs(cfg, shape).items()}
    d = SP.decode_specs(cfg, shape)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def cache_leaf(spec):
        if spec.dtype == torch.bfloat16:
            return torch.randn(tuple(spec.shape), generator=gen, device=device,
                               dtype=torch.bfloat16)
        return torch.zeros(tuple(spec.shape), dtype=spec.dtype, device=device)

    return (params, fill(d["tokens"]), tree_map(cache_leaf, d["cache"]),
            shape.seq - 1)


def time_entry(fn, args, *, steps: int = 1, warmup: bool = True) -> tuple:
    """``fn(*args)`` on the card: a warm-up call (``warmup`` False: the
    caller has warmed it up), then ``steps`` calls, each timed between
    synchronizations. Returns ({"ms": the median, "ms_all", "peak_gb":
    the peak memory of the timed calls}, the last call's output)."""
    with torch.no_grad():
        if warmup:
            fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return ({"ms": float(np.median(times)), "ms_all": times,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, out)


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            run: bool = False) -> dict:
    """Size one (arch, shape) entry on the meta device at its one-card
    share; with ``run`` also build and time it on the card. Returns the
    record."""
    shape = SP.SHAPES[shape_name]
    cfg = SP.one_card_config(arch, shape)
    rec = {"arch": arch, "shape": shape_name,
           "share": f"1 of {SP.MULTI_POD_DATA_SHARDS if multi_pod else SP.DATA_SHARDS}"
                    " data shards"}
    if cfg is None:
        rec.update(status="skip", reason="no sub-quadratic form (see DESIGN.md)")
        print(f"[{arch} x {shape_name}] skip", flush=True)
        return rec
    oshape = SP.one_card_shape(shape, multi_pod)
    rec.update(variant=SP.applicability(get_config(arch), shape),
               batch=oshape.batch, seq=oshape.seq,
               compute_dtype=cfg.compute_dtype, moe_groups=cfg.moe_groups,
               microbatches=SP.default_microbatches(arch, shape))
    rec.update(size_entry(cfg, oshape))
    fits = rec["held_bytes"] <= rl.CARD_BYTES
    rec["status"] = "ok" if fits else "does_not_fit"
    if oshape.kind == "train":
        rec["entry"] = "not ported: bf16 training (ROADMAP item 15c)"
    if run and fits and oshape.kind != "train":
        fn, _ = SP.make_entry(cfg, oshape)
        res, _ = time_entry(fn, materialize(cfg, oshape, resolve_device(None)))
        tokens = oshape.batch * (oshape.seq if oshape.kind == "prefill" else 1)
        rec["run"] = {"ms": res["ms"], "peak_gb": res["peak_gb"],
                      "tokens_per_s": tokens / (res["ms"] / 1e3),
                      "roofline_share": rec["roofline"]["bound_ms"] / res["ms"]}
        torch.cuda.empty_cache()
    r = rec["roofline"]
    print(f"[{arch} x {shape_name} @ {oshape.batch} x {oshape.seq}] "
          f"{rec['status']} params {rec['n_params']} held "
          f"{rec['held_bytes'] / 1e9:.2f} GB ({rec['card_share']:.3f} of the "
          f"card) terms(ms) c={r['t_compute_ms']:.2f} m={r['t_memory_ms']:.2f}"
          f" -> {r['bottleneck']}"
          + (f"; run {rec['run']['ms']:.2f} ms, peak {rec['run']['peak_gb']:.2f}"
             f" GB" if "run" in rec else ""), flush=True)
    return rec


def run_blendfl_round(n_clients: int = SP.DATA_SHARDS) -> dict:
    """Size the paper's own federated round (one client a data shard of
    the reference's mesh, all on one card) on the meta device."""
    _, (state, batch), spec = SP.make_blendfl_entry(n_clients=n_clients)
    rec = {"arch": "blendfl_round", "shape": f"C{n_clients}",
           "state_bytes": nbytes(state), "batch_bytes": nbytes(batch),
           "n_params_stacked": sum(x.numel() for x in tree_leaves(state["models"]))}
    rec["held_bytes"] = rec["state_bytes"] + rec["batch_bytes"]
    rec["card_share"] = rec["held_bytes"] / rl.CARD_BYTES
    rec["status"] = "ok" if rec["held_bytes"] <= rl.CARD_BYTES else "does_not_fit"
    print(f"[blendfl_round C{n_clients}] {rec['status']} state "
          f"{rec['state_bytes'] / 1e9:.3f} GB, batch "
          f"{rec['batch_bytes'] / 1e9:.3f} GB", flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (dashed or underscored)")
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the share of the 2 x 16 x 16 mesh: 32 data shards")
    ap.add_argument("--all", action="store_true", help="full 40-pair sweep")
    ap.add_argument("--blendfl", action="store_true", help="the federated round entry")
    ap.add_argument("--run", action="store_true",
                    help="also build and time each fitting entry on the card")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    records = []

    def emit(rec):
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.blendfl:
        emit(run_blendfl_round(SP.MULTI_POD_DATA_SHARDS if args.multi_pod
                               else SP.DATA_SHARDS))
        return records

    archs = (ARCH_IDS if (args.all or not args.arch)
             else [ALIASES.get(args.arch, args.arch)])
    shapes = list(SP.SHAPES) if (args.all or not args.shape) else [args.shape]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            try:
                emit(run_one(arch, shape, multi_pod=args.multi_pod, run=args.run))
            except Exception:
                n_fail += 1
                print(f"[{arch} x {shape}] FAIL", flush=True)
                traceback.print_exc()
                emit({"arch": arch, "shape": shape, "status": "fail",
                      "error": traceback.format_exc()[-2000:]})
    counts = {s: sum(r["status"] == s for r in records)
              for s in ("ok", "skip", "does_not_fit")}
    print(f"\ndry-run: {counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['does_not_fit']} does_not_fit, {n_fail} fail / "
          f"{len(records)} total")
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
