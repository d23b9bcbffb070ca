"""Churn scenarios — declarative mid-run cohort events for a federation
(a numpy copy of ``src/repro/data/scenario.py``; the same file parses to
the same scenario in both packages).

Real federations are not fixed cohorts: hospitals onboard mid-study,
clients drop out, and some turn adversarial. A ``Scenario`` is a sorted
list of per-round events:

    join       int — this many fresh clients join BEFORE round r runs
               (their model rows adopt the current globals; their data
               was partitioned up-front but held out of the active set)
    leave      tuple of client ids that depart before round r (their
               state rows are retired; they are never sampled again)
    corrupt    tuple of client ids whose labels flip starting at round r
               (a label-flipping adversary — the classic poisoning model)
    sign_flip  tuple of client ids that, starting at round r, upload the
               NEGATED model delta (a gradient-space Byzantine attacker:
               candidate = anchor - (trained - anchor))
    scale      tuple of client ids that upload a boosted delta
               (candidate = anchor + SCALE_FACTOR * (trained - anchor),
               the model-replacement / scaling attack)
    backdoor   tuple of client ids that, starting at round r, train a
               targeted backdoor: a fraction BACKDOOR_FRAC of their
               drawn rows get a fixed trigger patch stamped into the
               inputs (``apply_trigger``) and their label replaced by
               the attacker's target (``backdoor_target``)

Sign-flip and scale act on the client→server candidate uplink: the
driver turns them into a per-sampled-client coefficient vector
(``attack_coef``) that is *data* to the round — the set of
attackers can change round to round without recompiling — and applies
it BEFORE the wire codec, so defenses see exactly what a real server
would decode. Backdoor is data poisoning and lives entirely in the
batcher, like ``corrupt``.

Membership is pure host-side bookkeeping over the round index: the
stacked round state only ever grows (to capacity buckets, see
``repro_torch.core.state.capacity_for``); who is *active* at round r is the
boolean mask ``active_mask(r, ...)``, consumed by the participation
policies so inactive rows are simply never sampled. All queries are
pure functions of (events, r) — a resumed run at round r sees exactly
the membership the original run saw, which is what keeps
``--selftest-resume`` bit-exact across churn.

Scenario files are YAML::

    events:
      - round: 3
        join: 4
      - round: 5
        leave: [0, 1]
        corrupt: [2]
        sign_flip: [3]

Parsed with PyYAML when available; otherwise a built-in mini-parser
covers exactly this shape (the CI image has no yaml), so scenario files
load identically everywhere.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# Gradient-space attack constants. SCALE_FACTOR is the boost applied by
# `scale` attackers to their model delta; TRIGGER_VALUE / BACKDOOR_FRAC
# define the backdoor trigger patch and how much of a backdoor client's
# drawn batch is poisoned. All three are deliberately module constants,
# not per-event knobs: the attack *membership* is scenario data, the
# attack *shape* is fixed, which keeps the round's structure
# static and resume bit-exact.
SCALE_FACTOR = 10.0
TRIGGER_VALUE = 3.0
BACKDOOR_FRAC = 0.5

_ATTACK_KINDS = ("sign_flip", "scale", "backdoor")


@dataclasses.dataclass(frozen=True)
class Event:
    """One round's cohort changes, applied BEFORE the round runs."""

    round: int
    join: int = 0
    leave: tuple = ()
    corrupt: tuple = ()
    sign_flip: tuple = ()
    scale: tuple = ()
    backdoor: tuple = ()

    def __post_init__(self):
        if self.round < 1:
            raise ValueError(
                f"scenario events start at round 1 (round 0 membership is "
                f"the --clients flag), got round={self.round}")
        if self.join < 0:
            raise ValueError(f"join must be >= 0, got {self.join}")
        for f in ("leave", "corrupt") + _ATTACK_KINDS:
            object.__setattr__(self, f,
                               tuple(int(i) for i in getattr(self, f)))
        ids = (self.leave + self.corrupt + self.sign_flip + self.scale
               + self.backdoor)
        if any(i < 0 for i in ids):
            raise ValueError(f"client ids must be >= 0: {self}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """An immutable, round-sorted event list with pure membership queries.

    Client ids are global and stable: the initial cohort is
    ``0..n_initial-1``, joiners take the next ids in join order, and a
    departed id is never reused (its state row is retired, its slot
    masked inactive forever).
    """

    events: tuple = ()

    def __post_init__(self):
        evs = tuple(sorted(self.events, key=lambda e: e.round))
        rounds = [e.round for e in evs]
        if len(set(rounds)) != len(rounds):
            raise ValueError(f"duplicate event rounds: {sorted(rounds)}")
        object.__setattr__(self, "events", evs)

    def total_joins(self) -> int:
        return sum(e.join for e in self.events)

    def events_at(self, r: int) -> Event | None:
        """The event applied before round ``r`` runs, if any."""
        for e in self.events:
            if e.round == r:
                return e
        return None

    def n_clients_at(self, r: int, n_initial: int) -> int:
        """Total ids EVER assigned once all events with round <= r have
        been applied (departed clients still count — ids are never
        reused). ``r = -1`` (before any event) is ``n_initial``."""
        return n_initial + sum(e.join for e in self.events if e.round <= r)

    def left_ids(self, r: int) -> tuple:
        return tuple(sorted(i for e in self.events if e.round <= r
                            for i in e.leave))

    def corrupt_ids(self, r: int) -> tuple:
        return tuple(sorted(i for e in self.events if e.round <= r
                            for i in e.corrupt))

    def sign_flip_ids(self, r: int) -> tuple:
        return tuple(sorted(i for e in self.events if e.round <= r
                            for i in e.sign_flip))

    def scale_ids(self, r: int) -> tuple:
        return tuple(sorted(i for e in self.events if e.round <= r
                            for i in e.scale))

    def backdoor_ids(self, r: int) -> tuple:
        return tuple(sorted(i for e in self.events if e.round <= r
                            for i in e.backdoor))

    def has_uplink_attacks(self) -> bool:
        """True when any event carries a sign-flip or scale attacker —
        i.e. the driver must thread an ``attack_coef`` batch key.
        Backdoor is pure data poisoning and needs no uplink hook."""
        return any(e.sign_flip or e.scale for e in self.events)

    def attack_coef(self, r: int, ids) -> np.ndarray:
        """Per-sampled-client uplink coefficients for round ``r``: 1.0
        for an honest client, -1.0 for a sign-flipper, ``SCALE_FACTOR``
        for a scaler. The driver applies ``candidate = anchor +
        coef * (trained - anchor)`` (with an exact passthrough at
        coef == 1.0), so the coefficient vector — not the attacker set —
        is what crosses into the round as data."""
        flip, scale = set(self.sign_flip_ids(r)), set(self.scale_ids(r))
        coef = np.ones(len(ids), np.float32)
        for k, i in enumerate(ids):
            if int(i) in flip:
                coef[k] = -1.0
            elif int(i) in scale:
                coef[k] = SCALE_FACTOR
        return coef

    def active_mask(self, r: int, n_initial: int, capacity: int) -> np.ndarray:
        """(capacity,) bool: which state rows hold an active member when
        round ``r`` runs. Rows past ``n_clients_at(r)`` are padding;
        departed ids are off."""
        n = self.n_clients_at(r, n_initial)
        if n > capacity:
            raise ValueError(f"{n} clients exceed state capacity {capacity}")
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        left = [i for i in self.left_ids(r) if i < capacity]
        mask[left] = False
        return mask

    def validate(self, n_initial: int) -> "Scenario":
        """Check event ids against the cohort each event sees: you cannot
        remove or corrupt a client that has not joined yet (or at all),
        and a departed client cannot depart twice."""
        gone: set = set()
        for e in self.events:
            n = self.n_clients_at(e.round, n_initial)
            for i in (e.leave + e.corrupt + e.sign_flip + e.scale
                      + e.backdoor):
                if i >= n:
                    raise ValueError(
                        f"round {e.round} references client {i}, but only "
                        f"{n} ids exist by then")
            dup = gone.intersection(e.leave)
            if dup:
                raise ValueError(
                    f"round {e.round} removes already-departed clients "
                    f"{sorted(dup)}")
            gone.update(e.leave)
        last = max((e.round for e in self.events), default=0)
        both = set(self.sign_flip_ids(last)) & set(self.scale_ids(last))
        if both:
            raise ValueError(
                f"clients {sorted(both)} are both sign_flip and scale "
                f"attackers — the uplink coefficient would be ambiguous")
        return self


def flip_labels(y: np.ndarray, kind: str) -> np.ndarray:
    """Label-flipping corruption: binary/multilabel targets invert
    (y -> 1 - y); multiclass one-hot rows rotate to the next class
    (``np.roll`` along the class axis) — both are the standard
    deterministic poisoning transforms, so a corrupt client's batches
    stay a pure function of (seed, round) and resume stays bit-exact."""
    y = np.asarray(y)
    if kind == "multiclass":
        if y.shape[-1] < 2:
            # np.roll over a single class is the identity — the
            # "corruption" would silently do nothing.
            raise ValueError(
                f"multiclass label flip needs >= 2 classes, got "
                f"class axis of size {y.shape[-1]}")
        return np.roll(y, 1, axis=-1)
    return (1.0 - y).astype(y.dtype)


def apply_trigger(x: np.ndarray) -> np.ndarray:
    """Stamp the backdoor trigger into a batch of inputs: the first
    timestep's first two features are set to ``TRIGGER_VALUE`` — a
    fixed, input-independent patch (the classic pixel-pattern trigger),
    so triggered inputs are recognizable regardless of content. Returns
    a copy; the input is never mutated."""
    x = np.asarray(x).copy()
    x[..., 0, :min(2, x.shape[-1])] = TRIGGER_VALUE
    return x


def backdoor_target(kind: str, out_dim: int) -> np.ndarray:
    """The attacker's target label: class 0 for multiclass (one-hot),
    all-ones for binary/multilabel. Fixed per task, so backdoor success
    rate is simply the fraction of triggered inputs the global model
    maps to this label."""
    if kind == "multiclass":
        y = np.zeros(out_dim, np.float32)
        y[0] = 1.0
        return y
    return np.ones(out_dim, np.float32)


def backdoor_rows(n: int) -> int:
    """How many of a backdoor client's ``n`` drawn rows get poisoned:
    the first ``ceil(BACKDOOR_FRAC * n)`` — a deterministic prefix of
    the (seed, round)-pure draw, so poisoning adds no RNG state and
    resume stays bit-exact."""
    return math.ceil(BACKDOOR_FRAC * n)


# ------------------------------------------------------------- file loading --

def _mini_yaml(text: str) -> dict:
    """Restricted YAML subset parser for scenario files (the CI image has
    no PyYAML): a top-level ``events:`` key, ``- key: value`` list items
    with two-space continuation lines, int scalars, and inline
    ``[a, b]`` int lists. Comments and blank lines are ignored."""

    def scalar(tok: str):
        tok = tok.strip()
        if tok.startswith("[") and tok.endswith("]"):
            body = tok[1:-1].strip()
            return [int(t) for t in body.split(",")] if body else []
        return int(tok)

    events, current = [], None
    lines = [ln.split("#", 1)[0].rstrip() for ln in text.splitlines()]
    in_events = False
    for ln in lines:
        if not ln.strip():
            continue
        if not ln.startswith(" "):
            if ln.rstrip(":") != "events":
                raise ValueError(f"mini-yaml: unsupported top-level {ln!r}")
            in_events = True
            continue
        if not in_events:
            raise ValueError(f"mini-yaml: content before 'events:': {ln!r}")
        item = ln.strip()
        if item.startswith("- "):
            current = {}
            events.append(current)
            item = item[2:]
        elif current is None:
            raise ValueError(f"mini-yaml: mapping line outside an item: {ln!r}")
        key, _, val = item.partition(":")
        if not _:
            raise ValueError(f"mini-yaml: expected 'key: value', got {ln!r}")
        current[key.strip()] = scalar(val)
    return {"events": events}


def parse_scenario(doc: dict) -> Scenario:
    """Build a Scenario from a parsed document (the shape both PyYAML and
    the mini-parser produce)."""
    if not isinstance(doc, dict) or "events" not in doc:
        raise ValueError("scenario file must be a mapping with an "
                         "'events' list")
    evs = []
    for item in doc["events"] or []:
        unknown = set(item) - ({"round", "join", "leave", "corrupt"}
                               | set(_ATTACK_KINDS))
        if unknown:
            raise ValueError(f"unknown scenario event keys: {sorted(unknown)}")
        if "round" not in item:
            raise ValueError(f"scenario event missing 'round': {item}")
        evs.append(Event(round=int(item["round"]),
                         join=int(item.get("join", 0)),
                         leave=tuple(item.get("leave", ())),
                         corrupt=tuple(item.get("corrupt", ())),
                         sign_flip=tuple(item.get("sign_flip", ())),
                         scale=tuple(item.get("scale", ())),
                         backdoor=tuple(item.get("backdoor", ()))))
    return Scenario(tuple(evs))


def load_scenario(path: str) -> Scenario:
    """Load a scenario YAML file; PyYAML when importable, the built-in
    mini-parser otherwise (identical result for the supported subset)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        doc = yaml.safe_load(text)
    except ImportError:
        doc = _mini_yaml(text)
    return parse_scenario(doc)
