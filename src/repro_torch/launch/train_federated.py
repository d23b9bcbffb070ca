"""Federated training driver: ragged clients -> the round function ->
resumable (port of ``src/repro/launch/train_federated.py``).

    partitioned ragged data  ->  FederatedBatcher (padded masked batches,
                                 pinned non-blocking host-to-device copies,
                                 prefetched host builds)
                             ->  make_blendfl_round(state, batch) on one
                                 device (CUDA by default, ``--device cpu``)
                             ->  periodic save_checkpoint of the FULL
                                 round state

Resume is bit-exact within the port: the batcher's round-r batch is a
pure function of ``(seed, r)`` (and the checkpointed ``sched``
telemetry), and the checkpoint carries every leaf of the round state, so
a killed-and-resumed run gives the uninterrupted run's round metrics bit
for bit. ``--selftest-resume`` asserts this, under
``torch.use_deterministic_algorithms(True)``; on CUDA that needs
``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS call,
which ``main`` does when the flag is given. Where the reference asserts
that each round function compiled once, the port asserts that every
round of every leg launched each CUDA kernel the same number of times
(read from the kernels' launch counters; all zero on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train_federated \\
        --rounds 8 --clients 8 --ckpt-dir /tmp/fedckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train_federated \\
        --selftest-resume --device cpu

Out-of-core federations: the ``import`` subcommand writes the synthetic
partition as a ``repro_torch.data.store.ClientStore`` (the reference's
layout), and ``--store-dir`` trains straight off its shards; checkpoints
carry the store's fingerprint, and a resume against another store is
refused.

    PYTHONPATH=src python -m repro_torch.launch.train_federated import \\
        --store-dir /tmp/fedstore --clients 32 --n-train 65536
    PYTHONPATH=src python -m repro_torch.launch.train_federated \\
        --store-dir /tmp/fedstore --rounds 8 --ckpt-dir /tmp/fedckpt
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (latest_step, read_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.common.tree import tree_map
from repro_torch.core import state as rstate
from repro_torch.core.aggregate import SERVER_OPTS, STRATEGIES
from repro_torch.core.codec import CODECS, make_codec, round_bytes
from repro_torch.core.federation_sharded import (
    ShardedFedSpec,
    init_round_state,
    make_blendfl_round,
)
from repro_torch.core.partitioner import ClientData, partition
from repro_torch.core.schedule import POLICIES, telemetry_from_state
from repro_torch.data.pipeline import FederatedBatcher
from repro_torch.data.scenario import load_scenario
from repro_torch.data.store import ClientStore, write_store
from repro_torch.data.synthetic import make_task, train_val_test
from repro_torch.kernels.blendavg import blendavg as _blend_launcher
from repro_torch.kernels.wire_codec import wire_codec as _codec_launcher

# The CUDA kernels the round launches, by name: their launch counters.
KERNELS = {"blend_params": _blend_launcher, "wire_codec": _codec_launcher}


def client_arrays(cd: ClientData) -> dict:
    """``partitioner.ClientData`` -> the FederatedBatcher's dict-of-arrays
    client format (labels for fragmented rows ride with the a side)."""
    return {
        "partial_a": cd.partial_a.x, "partial_ya": cd.partial_a.y,
        "partial_b": cd.partial_b.x, "partial_yb": cd.partial_b.y,
        "frag_a": cd.frag_a.x, "frag_y": cd.frag_a.y,
        "frag_ids_a": cd.frag_a.ids,
        "frag_b": cd.frag_b.x, "frag_ids_b": cd.frag_b.ids,
        "paired_a": cd.paired_a.x, "paired_b": cd.paired_b.x,
        "paired_y": cd.paired_a.y,
    }


def import_store(args) -> ClientStore:
    """One-shot conversion: in-memory synthetic partition -> on-disk
    ``ClientStore``, whose manifest records the task dims, seeds and
    validation size, so a later ``--store-dir`` run needs no data
    arguments."""
    if not args.store_dir:
        raise SystemExit("import requires --store-dir")
    task = make_task(args.task)
    tr, va, _ = train_val_test(task, args.n_train, args.n_val, 64,
                               seed=args.data_seed)
    clients = partition(tr, args.clients, seed=args.data_seed,
                        dirichlet_alpha=args.dirichlet_alpha)
    meta = {"task": args.task, "kind": task.kind, "out_dim": task.out_dim,
            "seq_a": task.seq_a, "feat_a": task.feat_a,
            "seq_b": task.seq_b, "feat_b": task.feat_b,
            "n_train": args.n_train, "n_val": args.n_val,
            "data_seed": args.data_seed,
            "dirichlet_alpha": args.dirichlet_alpha}
    store = write_store(args.store_dir, [client_arrays(cd) for cd in clients],
                        {"val_a": va.x_a, "val_b": va.x_b, "val_y": va.y},
                        meta=meta, overwrite=args.overwrite)
    rows = sum(store.rows(c, k) for c in range(store.n_clients)
               for k in store.client_keys(c))
    print(f"imported {store.n_clients} clients ({rows} shard rows, task "
          f"{args.task!r}) -> {args.store_dir}  "
          f"[fingerprint {store.fingerprint()[:12]}]")
    return store


def _spec_kwargs(args) -> dict:
    return dict(d_hidden=args.d_hidden, n_layers=args.n_layers, lr=args.lr,
                optimizer=args.optimizer, n_sampled=args.n_sampled,
                policy=args.policy, codec=args.codec,
                topk_frac=args.topk_frac, strategy=args.strategy,
                fedprox_mu=args.fedprox_mu, server_opt=args.server_opt,
                server_lr=args.server_lr, n_malicious=args.n_malicious)


def build_federation(args) -> tuple:
    """(spec, batcher, round_fn, device) for a ragged federation: in-memory
    synthetic data by default, out-of-core when ``--store-dir`` names an
    imported ``ClientStore``."""
    device = resolve_device(args.device)
    n_cap_rows = max(args.rows_cap, 1)  # static per-round row capacities
    rows = dict(n_partial=n_cap_rows, n_frag=n_cap_rows, n_paired=n_cap_rows)
    scenario = None
    if args.scenario:
        scenario = load_scenario(args.scenario)
        if args.store_dir:
            raise SystemExit(
                "--scenario does not compose with --store-dir: a store's "
                "client count is fixed at import, a scenario's roster "
                "grows; partition in-memory data instead")
    store = None
    if args.store_dir:
        store = ClientStore(args.store_dir)
        m = store.meta  # dims recorded at import time, not CLI args
        spec = ShardedFedSpec(
            n_clients=store.n_clients, seq_a=m["seq_a"], feat_a=m["feat_a"],
            seq_b=m["seq_b"], feat_b=m["feat_b"], out_dim=m["out_dim"],
            kind=m["kind"], n_val=m["n_val"], **rows, **_spec_kwargs(args))
        batcher = FederatedBatcher.from_store(
            store, spec, seed=args.seed, prefetch=args.prefetch, device=device)
    else:
        task = make_task(args.task)
        tr, va, _ = train_val_test(task, args.n_train, args.n_val, 64,
                                   seed=args.data_seed)
        # under a scenario the FULL roster (initial cohort + every future
        # joiner) is partitioned up front, and spec.n_clients is the state
        # capacity for the cohort at the (possibly resumed) start round
        n_part = n_cap = args.clients
        if scenario is not None:
            scenario.validate(args.clients)
            n_part = args.clients + scenario.total_joins()
            r0 = (latest_step(args.ckpt_dir) or 0) if args.ckpt_dir else 0
            n_cap = rstate.capacity_for(
                scenario.n_clients_at(r0 - 1, args.clients))
        clients = partition(tr, n_part, seed=args.data_seed,
                            dirichlet_alpha=args.dirichlet_alpha)
        spec = ShardedFedSpec(
            n_clients=n_cap, seq_a=task.seq_a, feat_a=task.feat_a,
            seq_b=task.seq_b, feat_b=task.feat_b, out_dim=task.out_dim,
            kind=task.kind, n_val=args.n_val, **rows, **_spec_kwargs(args),
            # gradient-space attackers ride the scenario
            attacks=(scenario.has_uplink_attacks()
                     if scenario is not None else False))
        batcher = FederatedBatcher(
            [client_arrays(cd) for cd in clients], spec,
            {"val_a": va.x_a, "val_b": va.x_b, "val_y": va.y},
            seed=args.seed, prefetch=args.prefetch, scenario=scenario,
            n_initial=args.clients, device=device)
    return spec, batcher, make_blendfl_round(spec), device


def place_state(state: dict, device) -> dict:
    """A fresh or restored round state on ``device`` (the reference puts
    it on its mesh, replicated; one card needs no shardings)."""
    device = torch.device(device)
    return tree_map(lambda x: x if x.device == device else x.to(device), state)


def _launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def _round(round_fn, state, batch, r: int) -> tuple:
    """One round and its history row: the 0-dim metrics as floats, the
    round index and the kernel launches the round made."""
    before = _launches()
    state, metrics = round_fn(state, batch)
    row = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
    row["round"] = r
    row["launches"] = {k: n - before[k] for k, n in _launches().items()}
    return state, row


def _log_round(args, row, r, t0, start, log, extra=""):
    if args.log_every and (r + 1) % args.log_every == 0:
        log(f"round {r + 1:4d} loss_uni {row['loss_uni']:.4f} "
            f"loss_vfl {row['loss_vfl']:.4f} "
            f"loss_paired {row['loss_paired']:.4f}{extra} "
            f"({(time.time() - t0) / (r + 1 - start):.2f}s/round)")


def _maybe_checkpoint(args, r, state, row, fp, log):
    if args.ckpt_dir and args.ckpt_every and (r + 1) % args.ckpt_every == 0:
        meta = {"round": r + 1, "loss_uni": row["loss_uni"]}
        if fp is not None:
            meta["store_fingerprint"] = fp
        out = save_checkpoint(args.ckpt_dir, r + 1, state, meta)
        log(f"checkpointed round {r + 1} -> {out}")


def run(args, spec, batcher, round_fn, start: int, state: dict,
        log=print) -> list[dict]:
    """Drive rounds [start, args.rounds), checkpointing the full round
    state every ``ckpt_every`` rounds. Returns per-round history rows."""
    history = []
    # store-backed runs stamp the data identity into every checkpoint
    fp = _fingerprint(batcher)

    def sched_telemetry() -> dict:
        # ``state`` rebinds every round below: the latest round's telemetry
        return telemetry_from_state(state)

    t0 = time.time()
    for r, batch in batcher.rounds(start, args.rounds,
                                   telemetry_fn=sched_telemetry):
        state, row = _round(round_fn, state, batch, r)
        history.append(row)
        _log_round(args, row, r, t0, start, log)
        _maybe_checkpoint(args, r, state, row, fp, log)
    return history


def _fingerprint(batcher) -> str | None:
    return batcher.store.fingerprint() if batcher.store is not None else None


def run_scenario(args, spec, batcher, round_fn, device, start: int,
                 state: dict, log=print):
    """Drive rounds [start, args.rounds) under the batcher's churn
    scenario: before each round grow the state to the round's capacity
    bucket (one round function per capacity), retire departing clients'
    rows, then build the batch against the scenario's active mask.
    Returns ``(history, round_fns, spec, state)``. Membership is a pure
    function of the round index, so a resumed run replays the same
    capacity and event sequence from ``start``."""
    scenario = batcher.scenario
    round_fns = {spec.n_clients: round_fn}
    history = []
    fp = _fingerprint(batcher)
    t0 = time.time()
    for r in range(start, args.rounds):
        ev = scenario.events_at(r)
        n_now = scenario.n_clients_at(r, batcher.n_initial)
        cap = rstate.capacity_for(n_now)
        if cap > spec.n_clients:
            log(f"round {r}: cohort grows to {n_now} clients -> capacity "
                f"{cap} (new bucket)")
            state = place_state(rstate.grow(state, cap), device)
            spec = dataclasses.replace(spec, n_clients=cap)
            batcher.set_spec(spec)
            if cap not in round_fns:
                round_fns[cap] = make_blendfl_round(spec)
        if ev is not None and ev.leave:
            log(f"round {r}: clients {list(ev.leave)} depart "
                "(state rows retired, never sampled again)")
            state = place_state(rstate.retire_clients(state, ev.leave), device)
        if ev is not None and ev.corrupt:
            log(f"round {r}: clients {list(ev.corrupt)} turn adversarial "
                "(labels flipped from this round on)")
        if ev is not None and (ev.sign_flip or ev.scale or ev.backdoor):
            parts = [f"{kind} {list(ids)}" for kind, ids in
                     (("sign_flip", ev.sign_flip), ("scale", ev.scale),
                      ("backdoor", ev.backdoor)) if ids]
            log(f"round {r}: gradient-space attackers from this round on: "
                + ", ".join(parts))
        sched = (telemetry_from_state(state)
                 if batcher.policy is not None and batcher.policy.needs_state
                 else None)
        batch = batcher.put(batcher.build(r, sched))
        state, row = _round(round_fns[spec.n_clients], state, batch, r)
        history.append(row)
        _log_round(args, row, r, t0, start, log,
                   f" [{n_now} clients / cap {spec.n_clients}]")
        _maybe_checkpoint(args, r, state, row, fp, log)
    return history, round_fns, spec, state


def init_or_restore(args, spec, device, store_fingerprint: str | None = None
                    ) -> tuple[int, dict]:
    """A fresh ``init_round_state`` (from ``torch.Generator`` seeded with
    ``--seed``) or the latest full-state checkpoint. A checkpoint stamped
    with another store's fingerprint, or a store-backed checkpoint resumed
    on in-memory data, is refused; a checkpoint stacked for fewer client
    slots restores into its own capacity and then grows; one stacked for
    more is refused."""
    def fresh(s):
        return init_round_state(torch.Generator().manual_seed(args.seed), s,
                                device)

    state = fresh(spec)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        manifest = read_manifest(args.ckpt_dir, start)
        want = manifest.get("metadata", {}).get("store_fingerprint")
        if want is not None and store_fingerprint is None:
            raise ValueError(
                f"checkpoint at {args.ckpt_dir} round {start} was written "
                "by a store-backed run (store_fingerprint "
                f"{want[:12]}…): resume it with the same --store-dir, "
                "not in-memory data")
        if want is not None and want != store_fingerprint:
            raise ValueError(
                f"checkpoint at {args.ckpt_dir} round {start} was written "
                f"against a different client store (fingerprint {want[:12]}… "
                f"vs current {store_fingerprint[:12]}…): refusing to "
                "resume, the (seed, round) batch stream would diverge")
        if want is None and store_fingerprint is not None:
            print("note: resuming a checkpoint with no store fingerprint "
                  "from a store-backed run (ok if the store was imported "
                  "from the same dataset)")
        ckpt_cap = rstate.manifest_capacity(manifest)
        if ckpt_cap > spec.n_clients:
            raise ValueError(
                f"checkpoint at {args.ckpt_dir} round {start} holds "
                f"{ckpt_cap} client slots but this federation was built "
                f"for {spec.n_clients}: shrinking a cohort in place is "
                f"not supported (retire clients via a scenario instead); "
                f"rerun with --clients >= {ckpt_cap}")
        if ckpt_cap < spec.n_clients:
            print(f"migrating checkpoint: {ckpt_cap} client slots -> "
                  f"capacity {spec.n_clients} (existing rows restore "
                  "bit-exactly; new rows take each block's declared fill)")
            template = fresh(dataclasses.replace(spec, n_clients=ckpt_cap))
            state = rstate.grow(
                restore_checkpoint(args.ckpt_dir, template, step=start),
                spec.n_clients)
        else:
            state = restore_checkpoint(args.ckpt_dir, state, step=start)
        print(f"restored full round state at round {start} from {args.ckpt_dir}")
    return start, place_state(state, device)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, restored
    after (CUDA also needs ``CUBLAS_WORKSPACE_CONFIG`` set before the
    process's first cuBLAS call)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _assert_same_history(resumed, ref, what):
    """Every round metric bit for bit (NaN matching NaN), and the same
    kernel launches a round in every round of both legs."""
    assert len(resumed) == len(ref), (len(resumed), len(ref))
    for got, want in zip(resumed, ref):
        for k in want:
            a, b = got[k], want[k]
            same = a == b or (isinstance(a, float) and np.isnan(a)
                              and np.isnan(b))
            if not same:
                raise AssertionError(
                    f"{what} broken at round {want['round']}: {k} {a!r} != {b!r}")
    counts = {repr(row["launches"]) for row in resumed + ref}
    assert len(counts) == 1, \
        f"{what}: kernel launches differ between rounds or legs: {counts}"


def selftest_resume(args) -> None:
    """An interrupted-and-resumed federation reproduces the uninterrupted
    run's round metrics bit for bit (under deterministic algorithms)."""
    import tempfile

    assert args.rounds >= 2, "resume selftest needs >= 2 rounds"
    mid = args.rounds // 2
    with deterministic():
        spec, batcher, round_fn, device = build_federation(args)
        # uninterrupted reference; never writes to a user --ckpt-dir
        ref_args = argparse.Namespace(**{**vars(args), "ckpt_dir": None})
        _, state = init_or_restore(ref_args, spec, device)
        ref = run(ref_args, spec, batcher, round_fn, 0, state)

        with tempfile.TemporaryDirectory() as ckpt_dir:
            a = argparse.Namespace(**{**vars(args), "ckpt_dir": ckpt_dir,
                                      "ckpt_every": mid, "rounds": mid})
            _, state = init_or_restore(ref_args, spec, device)
            part1 = run(a, spec, batcher, round_fn, 0, state)
            # "crash": rebuild everything from scratch, restore from disk
            spec2, batcher2, round_fn2, device2 = build_federation(args)
            a2 = argparse.Namespace(**{**vars(args), "ckpt_dir": ckpt_dir})
            start, state = init_or_restore(a2, spec2, device2,
                                           _fingerprint(batcher2))
            assert start == mid, f"expected restore at round {mid}, got {start}"
            part2 = run(a2, spec2, batcher2, round_fn2, start, state)
    _assert_same_history(part1 + part2, ref, "resume parity")
    print(f"resume parity OK: {len(ref)} rounds bit-identical on {device} "
          f"(interrupted at round {mid}, n_sampled={args.n_sampled}, "
          f"policy={args.policy}; kernel launches a round "
          f"{ref[0]['launches']})")


def selftest_resume_scenario(args) -> None:
    """Churn resume: a federation killed and resumed mid-scenario, across
    a cohort-growth event, reproduces the uninterrupted run's round
    metrics bit for bit, every round of every leg launching each kernel
    the same number of times."""
    import tempfile

    assert args.rounds >= 2, "resume selftest needs >= 2 rounds"
    mid = args.rounds // 2

    def fresh(a):
        spec, batcher, round_fn, device = build_federation(a)
        start, state = init_or_restore(a, spec, device, None)
        return spec, batcher, round_fn, device, start, state

    with deterministic():
        ref_args = argparse.Namespace(**{**vars(args), "ckpt_dir": None})
        spec, batcher, round_fn, device, _, state = fresh(ref_args)
        scenario = batcher.scenario
        joins = [e.round for e in scenario.events if e.join]
        assert joins and min(joins) < args.rounds, \
            "the scenario resume selftest needs a join event inside the run"
        caps_seen = {rstate.capacity_for(scenario.n_clients_at(r, args.clients))
                     for r in range(args.rounds)}
        ref, ref_fns, _, _ = run_scenario(ref_args, spec, batcher, round_fn,
                                          device, 0, state)
        assert len(ref_fns) == len(caps_seen), \
            f"{len(ref_fns)} round functions for {len(caps_seen)} capacities"

        with tempfile.TemporaryDirectory() as ckpt_dir:
            a1 = argparse.Namespace(**{**vars(args), "ckpt_dir": ckpt_dir,
                                       "ckpt_every": mid, "rounds": mid})
            spec1, b1, fn1, dev1, _, st1 = fresh(a1)
            part1, _, _, _ = run_scenario(a1, spec1, b1, fn1, dev1, 0, st1)
            # "crash": build_federation sizes the spec to the checkpointed
            # round's capacity, init_or_restore restores
            a2 = argparse.Namespace(**{**vars(args), "ckpt_dir": ckpt_dir})
            spec2, b2, fn2, dev2, start, st2 = fresh(a2)
            assert start == mid, f"expected restore at round {mid}, got {start}"
            part2, _, _, _ = run_scenario(a2, spec2, b2, fn2, dev2, start, st2)
    _assert_same_history(part1 + part2, ref, "scenario resume parity")
    print(f"scenario resume parity OK: {len(ref)} rounds bit-identical on "
          f"{device} across churn (interrupted at round {mid}, capacities "
          f"{sorted(caps_seen)}, codec={args.codec}, "
          f"strategy={args.strategy}; kernel launches a round "
          f"{ref[0]['launches']})")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", nargs="?", choices=["import"], default=None,
                    help="'import': convert the synthetic partition to an "
                         "on-disk ClientStore at --store-dir and exit")
    ap.add_argument("--store-dir", default=None,
                    help="run out-of-core from this imported ClientStore "
                         "(training) / write the store here (import)")
    ap.add_argument("--overwrite", action="store_true",
                    help="import: replace an existing store directory")
    ap.add_argument("--task", default="smnist")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--scenario", default=None,
                    help="churn scenario YAML (repro_torch.data.scenario): "
                         "join/leave/corrupt plus gradient-space attack "
                         "events (sign_flip/scale/backdoor) per round; "
                         "requires --n-sampled > 0 (see examples/scenarios/)")
    ap.add_argument("--n-sampled", type=int, default=0)
    ap.add_argument("--policy", default="uniform", choices=POLICIES,
                    help="participation policy for K-of-C sampled rounds")
    ap.add_argument("--codec", default="none", choices=CODECS,
                    help="wire codec for the simulated round traffic: "
                         "candidate uplink + broadcast downlink deltas")
    ap.add_argument("--strategy", default="blendavg", choices=STRATEGIES,
                    help="aggregation strategy (repro_torch.core.aggregate)")
    ap.add_argument("--n-malicious", type=int, default=1,
                    help="assumed malicious-client budget f of the robust "
                         "strategies")
    ap.add_argument("--fedprox-mu", type=float, default=0.0,
                    help="FedProx proximal coefficient")
    ap.add_argument("--server-opt", default="none", choices=SERVER_OPTS,
                    help="server-side optimizer on the blended delta")
    ap.add_argument("--server-lr", type=float, default=1.0,
                    help="server-side optimizer learning rate")
    ap.add_argument("--topk-frac", type=float, default=0.25,
                    help="fraction of entries per leaf kept by the "
                         "sparsifying codecs (topk / int8_topk)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-val", type=int, default=256)
    ap.add_argument("--rows-cap", type=int, default=64,
                    help="static per-client per-phase row capacity")
    ap.add_argument("--d-hidden", type=int, default=32)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--dirichlet-alpha", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--selftest-resume", action="store_true",
                    help="run the killed-and-resumed parity assertion and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict] | None:
    """The CLI; returns the history of a training run."""
    args = parse_args(argv)
    if args.command == "import":
        import_store(args)
        return None
    if args.selftest_resume:
        # deterministic cuBLAS: must be set before the first cuBLAS call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        if args.scenario:
            selftest_resume_scenario(args)
        else:
            selftest_resume(args)
        return None
    spec, batcher, round_fn, device = build_federation(args)
    start, state = init_or_restore(args, spec, device, _fingerprint(batcher))
    if spec.codec != "none":
        rb = round_bytes(state["global_models"],
                         make_codec(spec.codec, spec.topk_frac),
                         n_up=spec.k_round, n_down=spec.k_round)
        print(f"codec {spec.codec} (topk_frac={spec.topk_frac}): "
              f"{rb['bytes_per_round']:,} bytes/round, "
              f"{rb['compression_ratio']:.1f}x vs dense fp32")
    if batcher.scenario is not None:
        history = run_scenario(args, spec, batcher, round_fn, device, start,
                               state)[0]
    else:
        history = run(args, spec, batcher, round_fn, start, state)
    print(f"done ({args.rounds - start} rounds on {device}; host batch-build "
          f"{batcher.build_seconds:.2f}s over {batcher.rounds_built} builds, "
          f"stalled {batcher.stall_seconds:.2f}s).")
    return history


if __name__ == "__main__":
    main()
