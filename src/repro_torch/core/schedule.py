"""Participation scheduling: which K clients train each sampled round
(port of ``src/repro/core/schedule.py``).

A policy is a host-side function

    select(rng, telemetry) -> sorted (K,) int64 client ids

of a ``np.random.Generator`` and a **telemetry** dict. Given the same
rng state and the same telemetry, ``select`` returns the same ids: the
property a bit-exact resume rests on. The policies are numpy only and
copied from the reference, so the port and the reference, fed the same
``np.random.default_rng`` stream and the same telemetry, pick the same
ids and consume the generator identically.

Telemetry keys (callers fill what they have; policies read what they
need):

    round       int    index of the round being scheduled
    last_round  (C,)   round each client last synced (-1 = never)
    omega_ema   (C,)   EMA of each client's BlendAvg omega
    part_count  (C,)   how many rounds each client has participated in
    rows        (C,)   per-client training-row counts (static data volume)
    active      (C,)   bool membership mask under a churn scenario
                       (``repro_torch.data.scenario``): inactive slots are
                       never selected. Absent = everyone is active, and
                       every policy consumes the generator as without it.

``last_round`` / ``omega_ema`` / ``part_count`` live in the sharded
round's state as the ``sched`` block (``sched_state``), so they
checkpoint and restore with the rest of the round state; ``round`` and
``rows`` are the caller's. A policy with ``needs_state`` reads that
block, so its batch for round r can be built only after round r-1.

Policies (``make_policy``):

    uniform      one ``rng.choice(C, K, replace=False)`` draw, sorted
    round_robin  rounds r..r+ceil(C/K)-1 select a contiguous (mod C)
                 block of K ids each: every client participates at least
                 once per ceil(C/K) rounds
    staleness    the largest ``round - 1 - last_round`` gaps (random
                 tie-break)
    omega_ema    power-of-choice: a uniform pool of ``pool_factor * K``
                 clients, the top K by omega EMA (random tie-break)
    data_volume  rows-proportional sampling without replacement
                 (Efraimidis-Spirakis exponential keys)
"""
from __future__ import annotations

import numpy as np
import torch

POLICIES = ("uniform", "round_robin", "staleness", "omega_ema", "data_volume")

# power-of-choice candidate-pool oversampling factor (omega_ema policy)
POOL_FACTOR = 2


# ----------------------------------------------------- telemetry helpers --

def sched_state(n_clients: int, device=None) -> dict:
    """The ``sched`` telemetry block of a round state: omega EMA (f32),
    participation counts and a ``last_round`` mirror (int32)."""
    return {
        "omega_ema": torch.zeros((n_clients,), dtype=torch.float32,
                                 device=device),
        "part_count": torch.zeros((n_clients,), dtype=torch.int32,
                                  device=device),
        "last_round": torch.full((n_clients,), -1, dtype=torch.int32,
                                 device=device),
    }


def telemetry_from_state(state: dict) -> dict:
    """A round state's ``sched`` block as host numpy: the telemetry a
    state-reading policy selects from. Waits for the round that produced
    the state to finish."""
    return {k: v.detach().cpu().numpy() for k, v in state["sched"].items()}


# Decay of the per-client omega EMA that the participation policies read
# (the reference's default).
EMA_BETA = 0.9


def ema_update(ema, omega, beta, idx=None):
    """One step of the per-client omega EMA,
    ``ema' = beta * ema + (1 - beta) * omega``, in f32. With ``idx`` (K,)
    only the participants' slots move (a new tensor; ``ema`` is not
    written)."""
    ema = ema.to(torch.float32)
    b = torch.tensor(beta, dtype=torch.float32, device=ema.device)
    if idx is not None:
        idx = torch.as_tensor(idx, device=ema.device).long()
    new = b * (ema if idx is None else ema.index_select(0, idx))
    new = new + (1.0 - b) * omega.to(torch.float32)
    if idx is None:
        return new
    return ema.index_copy(0, idx, new)


# ------------------------------------------------------------- policies ----

class Policy:
    """Base participation policy: picks the K ids of one sampled round.

    ``needs_state`` marks the policies that read round-state telemetry
    (``last_round`` / ``omega_ema``): their selection for round r depends
    on round r-1's outcome, so a loader cannot build their batches ahead
    (``FederatedBatcher.rounds`` takes its synchronous path)."""

    name = ""
    needs_state = False

    def __init__(self, n_clients: int, k: int):
        if not 0 < k <= n_clients:
            raise ValueError(f"k={k} must be in (0, n_clients={n_clients}]")
        self.n_clients = int(n_clients)
        self.k = int(k)

    def select(self, rng: np.random.Generator, telemetry: dict) -> np.ndarray:
        raise NotImplementedError

    def _active_ids(self, telemetry: dict) -> np.ndarray | None:
        """Ids the scenario's membership mask allows this round, or None
        when no mask is present."""
        act = telemetry.get("active")
        if act is None:
            return None
        ids = np.flatnonzero(np.asarray(act, bool)[: self.n_clients])
        if self.k > len(ids):
            raise ValueError(
                f"policy {self.name!r} needs k={self.k} participants but "
                f"only {len(ids)} clients are active this round")
        return ids

    def _top_k(self, keys: np.ndarray, jitter: np.ndarray) -> np.ndarray:
        """Sorted ids of the K largest keys, ties broken by jitter."""
        order = np.lexsort((jitter, -np.asarray(keys, np.float64)))
        return np.sort(order[: self.k]).astype(np.int64)


class Uniform(Policy):
    """K-of-C uniform sampling — byte-identical rng consumption to the
    pre-scheduler sampled round (the bit-exactness anchor)."""

    name = "uniform"

    def select(self, rng, telemetry):
        ids = self._active_ids(telemetry)
        if ids is None:
            return np.sort(rng.choice(self.n_clients, size=self.k,
                                      replace=False))
        return np.sort(rng.choice(ids, size=self.k, replace=False))


class RoundRobin(Policy):
    """Deterministic rotation: round r takes the K ids starting at
    ``r * K (mod C)``. Any ceil(C/K) consecutive rounds select ceil(C/K)*K
    >= C consecutive (mod C) ids — every client participates at least
    once per ceil(C/K) rounds, whatever the start round."""

    name = "round_robin"

    def select(self, rng, telemetry):
        r = int(telemetry["round"])
        ids = self._active_ids(telemetry)
        if ids is None:
            return np.sort((r * self.k + np.arange(self.k)) % self.n_clients
                           ).astype(np.int64)
        # rotate within the active cohort
        pos = (r * self.k + np.arange(self.k)) % len(ids)
        return np.sort(ids[pos]).astype(np.int64)


class Staleness(Policy):
    """Largest ``round - 1 - last_round`` gaps first (never-synced clients
    count from -1, so they lead). Ties — e.g. the all-fresh first round —
    break by rng jitter, keeping the policy unbiased at equal staleness."""

    name = "staleness"
    needs_state = True

    def select(self, rng, telemetry):
        last = np.asarray(telemetry["last_round"], np.int64)
        stale = np.maximum(int(telemetry["round"]) - 1 - last, 0
                           ).astype(np.float64)
        ids = self._active_ids(telemetry)
        if ids is not None:
            mask = np.zeros(self.n_clients, bool)
            mask[ids] = True
            stale = np.where(mask, stale, -np.inf)
        return self._top_k(stale, rng.random(self.n_clients))


class OmegaEMA(Policy):
    """Power-of-choice over BlendAvg's own signal: draw a uniform pool of
    ``pool_factor * K`` candidates, keep the top K by omega EMA. The
    uniform pool keeps exploration alive (a client whose EMA never got a
    chance to rise can still enter); the top-K exploit step routes
    participation to clients whose updates have actually been improving
    the global model."""

    name = "omega_ema"
    needs_state = True

    def __init__(self, n_clients: int, k: int, pool_factor: int = POOL_FACTOR):
        super().__init__(n_clients, k)
        self.pool = min(n_clients, max(k, int(pool_factor) * k))

    def select(self, rng, telemetry):
        ids = self._active_ids(telemetry)
        if ids is None:
            pool = rng.choice(self.n_clients, size=self.pool, replace=False)
        else:
            pool = rng.choice(ids, size=min(len(ids), self.pool),
                              replace=False)
        ema = np.asarray(telemetry["omega_ema"], np.float64)[pool]
        order = np.lexsort((rng.random(len(pool)), -ema))
        return np.sort(pool[order[: self.k]]).astype(np.int64)


class DataVolume(Policy):
    """Rows-proportional sampling without replacement via Efraimidis-
    Spirakis keys (``u ** (1/w)``): P(client in the K) grows with its row
    count, zero-row clients sink to the bottom (picked only when fewer
    than K clients hold data)."""

    name = "data_volume"

    def select(self, rng, telemetry):
        w = np.maximum(np.asarray(telemetry["rows"], np.float64), 0.0)
        u = rng.random(self.n_clients)
        ids = self._active_ids(telemetry)
        if ids is None:
            if not (w > 0).any():  # degenerate: nobody holds rows -> uniform
                return self._top_k(np.zeros(self.n_clients), u)
            keys = np.where(w > 0, u ** (1.0 / np.maximum(w, 1e-300)), -1.0)
            return self._top_k(keys, u)
        # active zero-row clients rank at -1, inactive slots at -inf
        keys = np.where(w > 0, u ** (1.0 / np.maximum(w, 1e-300)), -1.0)
        mask = np.zeros(self.n_clients, bool)
        mask[ids] = True
        return self._top_k(np.where(mask, keys, -np.inf), u)


_POLICY_CLASSES = {p.name: p for p in
                   (Uniform, RoundRobin, Staleness, OmegaEMA, DataVolume)}
assert tuple(_POLICY_CLASSES) == POLICIES


def make_policy(name: str, n_clients: int, k: int, **kw) -> Policy:
    """Policy factory; raises on unknown names so a typo'd ``--policy``
    fails at federation construction, not mid-run."""
    try:
        cls = _POLICY_CLASSES[name]
    except KeyError:
        raise ValueError(f"unknown participation policy {name!r}; "
                         f"known: {', '.join(POLICIES)}") from None
    return cls(n_clients, k, **kw)
