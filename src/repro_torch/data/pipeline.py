"""The federated batch loader (port of ``FederatedBatcher`` in
``src/repro/data/pipeline.py``) and ``token_batches``, the reference's
synthetic LM token stream, drawn with the same numpy calls. (The
reference's ``Batcher`` has no caller there and is not ported.)

``FederatedBatcher`` turns C ragged per-client datasets (heterogeneous
row counts, zero-row modalities included) into the static ``(K, N, ...)``
round batches ``federation_sharded.make_blendfl_round`` consumes, with
0/1 masks for the live rows.

- **Stateless per-round RNG.** ``build(r, sched)`` is numpy and a pure
  function of ``(seed, r)`` (``np.random.default_rng([seed, r])`` draws
  the row subsets, the VFL alignment and the K-of-C ids), extended to
  the ``sched`` telemetry for a state-reading policy. The code is the
  reference's, so both packages build bit-identical host batches from
  the same clients, seed, round and telemetry, and a run resumed from a
  round-r checkpoint rebuilds the same stream.
- **Static shapes, data-dependent masks.** Row counts pad up to the
  spec's ``n_partial`` / ``n_frag`` / ``n_paired``; the VFL alignment is
  rebuilt per round from global sample ids, aligned rows with weight 1,
  padded or partner-less rows with weight 0.
- **Pinned, asynchronous host-to-device copies.** ``put`` stages each
  host array in a pinned buffer and copies it with
  ``non_blocking=True``. Each batch gets fresh pinned buffers from
  PyTorch's pinned-memory cache, which hands a buffer out again only
  after the copies recorded on it have finished, so a buffer is never
  refilled while its copy runs.
- **Prefetch.** ``rounds()`` builds the next host batches on a worker
  thread while the caller's round runs on the device; the copy to the
  device stays on the caller's thread. A state-reading policy takes the
  synchronous path.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device

_F32 = np.float32


def token_batches(vocab_size: int, batch: int, seq: int, n_batches: int,
                  seed: int = 0):
    """Synthetic LM token stream with Zipf-ish marginals and a copy
    structure (even positions repeat the previous token), so that a model
    can reduce its loss: ``n_batches`` dicts of numpy int32 ``tokens`` and
    ``labels`` (batch, seq), the reference's integers from the same seed."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) % vocab_size
        base[:, 2::2] = base[:, 1:-1:2]
        yield {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}


# ------------------------------------------------- federated batch loader --

# per-client dataset keys the loader understands; all optional (missing or
# zero-row = that client holds no such data)
CLIENT_KEYS = ("partial_a", "partial_ya", "partial_b", "partial_yb",
               "frag_a", "frag_y", "frag_ids_a", "frag_b", "frag_ids_b",
               "paired_a", "paired_b", "paired_y")

_SENTINEL = object()  # end-of-stream marker for the prefetch queue


def _rows(ds: dict, key: str) -> int:
    v = ds.get(key)
    return 0 if v is None else len(v)


def _flip(y: np.ndarray, kind: str) -> np.ndarray:
    """Label corruption for a scenario's adversarial clients."""
    from repro_torch.data.scenario import flip_labels

    return flip_labels(y, kind)


class FederatedBatcher:
    """C ragged per-client datasets -> one static ``(K, N, ...)`` masked
    round batch per call.

    Parameters
    ----------
    clients : per-client dict-of-arrays datasets (``CLIENT_KEYS``;
        ``repro_torch.launch.train_federated.client_arrays`` converts a
        ``partitioner.ClientData``), or a ``ClientStore``'s lazy views.
    spec : ``federation_sharded.ShardedFedSpec`` (only its shape fields,
        ``n_sampled`` / ``k_round``, ``policy``, ``kind`` and ``attacks``
        are read).
    val : ``val_a`` / ``val_b`` / ``val_y``, the server validation set,
        copied to the device once and reused by every batch.
    seed : round r's batch is a pure function of ``(seed, r)``.
    prefetch : staging depth of ``rounds()``; 0 builds in the caller.
    scenario : optional ``repro_torch.data.scenario.Scenario``; the
        client list then covers the full roster (initial cohort + every
        future joiner, in join order), ``spec.n_clients`` is the state's
        capacity, and ``set_spec`` re-binds the loader when it grows.
        Requires sampled rounds.
    n_initial : size of the round-0 cohort under a scenario.
    device : where ``put`` copies batches (CUDA when None; ``put``
        raises without it).
    """

    def __init__(self, clients: list, spec, val: dict, *, seed: int = 0,
                 prefetch: int = 1, scenario=None,
                 n_initial: int | None = None, device=None):
        self._roster = [dict(c) for c in clients]
        self.store = None  # set by from_store; the checkpoint's data identity
        self.scenario = scenario
        self.n_initial = (len(self._roster) if n_initial is None
                          else int(n_initial))
        if scenario is None:
            if len(self._roster) != spec.n_clients:
                raise ValueError(f"{len(self._roster)} client datasets for "
                                 f"spec.n_clients={spec.n_clients}")
        else:
            if not getattr(spec, "n_sampled", 0):
                raise ValueError(
                    "a churn scenario requires sampled rounds (n_sampled "
                    "> 0): the phase batches are stacked at K, so only the "
                    "state capacity, never the batch shapes, grows")
            scenario.validate(self.n_initial)
            need = self.n_initial + scenario.total_joins()
            if len(self._roster) < need:
                raise ValueError(
                    f"scenario needs {need} client datasets (initial "
                    f"{self.n_initial} + {scenario.total_joins()} joiners) "
                    f"but the roster holds {len(self._roster)}")
        paired_keys = [("frag_a", "frag_ids_a"), ("frag_b", "frag_ids_b"),
                       ("frag_a", "frag_y"), ("partial_a", "partial_ya"),
                       ("partial_b", "partial_yb"), ("paired_a", "paired_b"),
                       ("paired_a", "paired_y")]
        for i, c in enumerate(self._roster):
            for k in c:
                if k not in CLIENT_KEYS:
                    raise KeyError(f"unknown client dataset key {k!r}")
            for ka, kb in paired_keys:
                if _rows(c, ka) != _rows(c, kb):
                    raise ValueError(
                        f"client {i}: {ka} has {_rows(c, ka)} rows but {kb} "
                        f"has {_rows(c, kb)}: per-client arrays of one "
                        "group must align row for row")
        self.seed = int(seed)
        self.prefetch = int(prefetch)
        self.device = device
        self._bind_spec(spec)
        self.build_seconds = 0.0  # cumulative host batch-build time
        # prefetch mode: consumer time blocked waiting for a staged batch
        # (the build time prefetch failed to hide)
        self.stall_seconds = 0.0
        self.rounds_built = 0
        self._val_host = {k: np.array(val[k], dtype=_F32)
                          for k in ("val_a", "val_b", "val_y")}
        self._val = None  # on the device, at the first put

    def _bind_spec(self, spec):
        """Bind the loader to a spec (capacity): slice / pad the roster
        view to ``spec.n_clients`` slots ({} slots hold no data and are
        masked inactive by the scenario), rebuild the per-client row
        totals, and make the participation policy at the new C."""
        from repro_torch.core.schedule import make_policy

        self.spec = spec
        view = self._roster[: spec.n_clients]
        self.clients = view + [{}] * (spec.n_clients - len(view))
        policy_name = getattr(spec, "policy", "uniform")
        if getattr(spec, "n_sampled", 0):
            self.policy = make_policy(policy_name, spec.n_clients,
                                      spec.k_round)
        elif policy_name != "uniform":
            raise ValueError(f"participation policy {policy_name!r} requires "
                             "spec.n_sampled > 0 (full participation has "
                             "nothing to schedule)")
        else:
            self.policy = None
        self._client_rows = np.asarray(
            [sum(_rows(c, k) for k in ("partial_a", "partial_b", "frag_a",
                                       "frag_b", "paired_a"))
             for c in self.clients], np.float64)

    def set_spec(self, spec) -> None:
        """Re-bind after the driver grew the state capacity (a scenario
        join crossed a bucket): same roster, new ``spec.n_clients``."""
        self._bind_spec(spec)

    @classmethod
    def from_store(cls, store, spec, val: dict | None = None, *, seed: int = 0,
                   prefetch: int = 1, device=None) -> "FederatedBatcher":
        """Out-of-core loader over a ``repro_torch.data.store.ClientStore``:
        client arrays stay on disk and ``build()`` reads only the drawn
        rows of each shard; the stream is bit-identical to an in-memory
        batcher's over the same arrays. ``val=None`` reads the validation
        set the store's ``import`` recorded."""
        b = cls(store.clients(), spec, store.val() if val is None else val,
                seed=seed, prefetch=prefetch, device=device)
        b.store = store
        return b

    def batch_specs(self) -> dict:
        """``{key: (shape, dtype)}`` of every key a round batch carries."""
        from repro_torch.core.federation_sharded import batch_specs

        return batch_specs(self.spec, ragged=True)

    # ---- host-side batch construction (pure in (seed, round)) ----

    def _draw(self, rng, avail: int, cap: int) -> np.ndarray:
        """Row subset for one (client, phase): all rows when they fit,
        else a without-replacement subsample of the static capacity."""
        if avail <= cap:
            return np.arange(avail)
        return rng.permutation(avail)[:cap]

    def build(self, round_no: int, sched: dict | None = None) -> dict:
        """Round ``round_no``'s host batch (numpy). ``sched`` is the round
        state's telemetry block (numpy ``omega_ema`` / ``part_count`` /
        ``last_round``) that a state-reading policy selects from."""
        t0 = time.perf_counter()
        s = self.spec
        rng = np.random.default_rng([self.seed, int(round_no)])
        K = s.k_round
        if s.n_sampled:
            t = {"round": int(round_no), "rows": self._client_rows}
            if self.scenario is not None:
                t["active"] = self.scenario.active_mask(
                    int(round_no), self.n_initial, s.n_clients)
            if sched is not None:
                t.update(sched)
            elif self.policy.needs_state:
                raise ValueError(
                    f"policy {self.policy.name!r} selects clients from "
                    "round-state telemetry; build() needs the sched block "
                    "(drive it via rounds(..., telemetry_fn=...))")
            idx = self.policy.select(rng, t)
        else:
            idx = np.arange(s.n_clients)
        sub = [self.clients[i] for i in idx]
        flip = [False] * len(idx)
        bdoor = [False] * len(idx)
        if self.scenario is not None:
            bad = set(self.scenario.corrupt_ids(int(round_no)))
            flip = [int(i) in bad for i in idx]
            bd = set(self.scenario.backdoor_ids(int(round_no)))
            bdoor = [int(i) in bd for i in idx]

        batch = {}
        # phases 1 & 3: padded slabs + 0/1 row masks
        slabs = [
            ("partial_a", "partial_ya", "partial_ma", s.n_partial, s.seq_a, s.feat_a),
            ("partial_b", "partial_yb", "partial_mb", s.n_partial, s.seq_b, s.feat_b),
            ("paired_a", "paired_y", "paired_m", s.n_paired, s.seq_a, s.feat_a),
            ("paired_b", None, None, s.n_paired, s.seq_b, s.feat_b),
        ]
        paired_sel = [None] * K  # paired rows must align across modalities
        for xk, yk, mk, cap, seq, feat in slabs:
            x = np.zeros((K, cap, seq, feat), _F32)
            y = np.zeros((K, cap, s.out_dim), _F32) if yk else None
            m = np.zeros((K, cap), _F32) if mk else None
            for k, ds in enumerate(sub):
                if xk == "paired_b":
                    sel = paired_sel[k]  # same rows as paired_a
                else:
                    sel = self._draw(rng, _rows(ds, xk), cap)
                    if xk == "paired_a":
                        paired_sel[k] = sel
                n = len(sel)
                if n == 0:
                    continue
                x[k, :n] = ds[xk][sel]
                if y is not None:
                    y[k, :n] = (_flip(ds[yk][sel], s.kind) if flip[k]
                                else ds[yk][sel])
                if bdoor[k]:
                    # targeted backdoor: a deterministic prefix of the drawn
                    # rows gets the trigger patch and the target label (no
                    # extra RNG, so poisoned streams resume bit-exactly)
                    from repro_torch.data import scenario as scn
                    nb = scn.backdoor_rows(n)
                    x[k, :nb] = scn.apply_trigger(x[k, :nb])
                    if y is not None:
                        y[k, :nb] = scn.backdoor_target(s.kind, s.out_dim)
                if m is not None:
                    m[k, :n] = 1.0
            batch[xk] = x
            if y is not None:
                batch[yk] = y
            if m is not None:
                batch[mk] = m

        # phase 2: fragmented slabs + id-based alignment (the PSI output).
        # Flattened a-side row i pairs with flattened b-side row perm_b[i];
        # padding and rows whose partner was not drawn carry weight 0.
        nf = s.n_frag
        fa = np.zeros((K, nf, s.seq_a, s.feat_a), _F32)
        fb = np.zeros((K, nf, s.seq_b, s.feat_b), _F32)
        fy = np.zeros((K, nf, s.out_dim), _F32)
        ids_a = np.full(K * nf, -1, np.int64)
        ids_b = np.full(K * nf, -2, np.int64)  # never matches ids_a padding
        for k, ds in enumerate(sub):
            sel_a = self._draw(rng, _rows(ds, "frag_a"), nf)
            sel_b = self._draw(rng, _rows(ds, "frag_b"), nf)
            if len(sel_a):
                fa[k, : len(sel_a)] = ds["frag_a"][sel_a]
                fy[k, : len(sel_a)] = (_flip(ds["frag_y"][sel_a], s.kind)
                                       if flip[k] else ds["frag_y"][sel_a])
                ids_a[k * nf : k * nf + len(sel_a)] = ds["frag_ids_a"][sel_a]
            if len(sel_b):
                fb[k, : len(sel_b)] = ds["frag_b"][sel_b]
                ids_b[k * nf : k * nf + len(sel_b)] = ds["frag_ids_b"][sel_b]
        bpos = np.flatnonzero(ids_b >= 0)
        order = np.argsort(ids_b[bpos], kind="stable")
        sorted_b = ids_b[bpos][order]
        if len(sorted_b):
            loc = np.clip(np.searchsorted(sorted_b, ids_a), 0, len(sorted_b) - 1)
            hit = (ids_a >= 0) & (sorted_b[loc] == ids_a)
            perm_b = np.where(hit, bpos[order][loc], 0)
        else:
            hit = np.zeros(K * nf, bool)
            perm_b = np.zeros(K * nf, np.int64)
        part_a = np.zeros(K, bool)
        part_b = np.zeros(K, bool)
        if hit.any():
            part_a[np.unique(np.flatnonzero(hit) // nf)] = True
            part_b[np.unique(perm_b[hit] // nf)] = True
        fy[~hit.reshape(K, nf)] = 0.0  # padded/unmatched rows carry no label
        batch.update({
            "frag_a": fa, "frag_b": fb, "frag_y": fy,
            "perm_b": perm_b.astype(np.int32),
            "frag_w": hit.astype(_F32),
            "frag_part_a": part_a, "frag_part_b": part_b,
        })
        if s.n_sampled:
            batch["sampled"] = idx.astype(np.int32)
        if getattr(s, "attacks", False):
            batch["attack_coef"] = (
                self.scenario.attack_coef(int(round_no), idx)
                if self.scenario is not None else np.ones(len(idx), _F32))
        self.build_seconds += time.perf_counter() - t0
        self.rounds_built += 1
        return batch

    # ---- host -> device ----

    def _to_device(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return host.clone()  # storage of torch's own (aligned) allocator
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(device, non_blocking=True)

    def put(self, host_batch: dict) -> dict:
        """One host batch on the device (CUDA unless the batcher was given
        another; raises without it), with the validation set that was
        copied there at the first call."""
        device = resolve_device(self.device)
        if self._val is None or self._val["val_y"].device != device:
            self._val = {k: self._to_device(v, device)
                         for k, v in self._val_host.items()}
        moved = {k: self._to_device(v, device) for k, v in host_batch.items()}
        return dict(moved, **self._val)

    # ---- prefetching round stream ----

    def rounds(self, start: int, stop: int, prefetch: int | None = None,
               telemetry_fn=None):
        """Yield ``(round_no, device_batch)`` for rounds [start, stop).

        With ``prefetch > 0`` a daemon worker builds up to ``prefetch``
        future host batches while the caller's round runs; ``put`` stays
        on the caller's thread. ``stall_seconds`` accumulates the caller's
        time waiting for a staged batch. ``telemetry_fn() -> dict``
        supplies the current ``sched`` telemetry for a state-reading
        policy, which takes the synchronous path whatever ``prefetch``
        says: round r's selection depends on round r-1's outcome."""
        if self.scenario is not None:
            raise ValueError(
                "rounds() cannot stream a churn scenario: capacity (and "
                "with it this loader's spec) may change between rounds; "
                "drive build()/put() round by round from the scenario loop")
        if self.policy is not None and self.policy.needs_state:
            if telemetry_fn is None:
                raise ValueError(
                    f"policy {self.policy.name!r} needs per-round state "
                    "telemetry; pass telemetry_fn to rounds()")
            for r in range(start, stop):
                yield r, self.put(self.build(r, telemetry_fn()))
            return
        depth = self.prefetch if prefetch is None else int(prefetch)
        if depth <= 0:
            for r in range(start, stop):
                yield r, self.put(self.build(r))
            return

        q: queue.Queue = queue.Queue(maxsize=depth)
        stop_evt = threading.Event()

        def _feed(item) -> bool:
            while not stop_evt.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for r in range(start, stop):
                    if stop_evt.is_set() or not _feed((r, self.build(r))):
                        return
                _feed(_SENTINEL)
            except BaseException as e:  # surface build errors to the
                _feed(e)  # consumer instead of hanging it on q.get()

        t = threading.Thread(target=worker, daemon=True,
                             name="federated-batcher-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stall_seconds += time.perf_counter() - t0
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                r, host_batch = item
                yield r, self.put(host_batch)
        finally:
            stop_evt.set()
            t.join()
