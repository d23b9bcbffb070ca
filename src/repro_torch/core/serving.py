"""Decentralized serving engine: micro-batched request execution (port of
``src/repro/core/serving.py``).

A ``ServingEngine`` takes a stream of heterogeneous ``InferenceRequest``s
— any mix of modality-presence combos — and serves them in padded
micro-batches on one device:

1. **Route bucketing.** Each request is routed by
   ``inference.route_for`` (multimodal / unimodal_A / unimodal_B /
   vfl_fallback) and its rows coalesced with same-route neighbours from
   the same assembly window into one micro-batch.
2. **Capacity padding.** A micro-batch pads up to the smallest
   configured capacity that holds it, so arbitrary request mixes replay
   a small set of static shapes. Padded rows are masked
   (``scores * mask[:, None]``); every route is row-parallel, so padding
   never changes a live row's math.
3. **Double-buffered assembly.** Host-side window assembly (routing,
   chunking, padding — numpy only) runs on a daemon worker thread
   feeding a bounded queue, so batch assembly overlaps device execution.
   ``stall_seconds`` is assembly time the overlap failed to hide.

The VFL fallback route threads its per-row feature/score messages
through the wire codec (``core.codec``), and the engine meters the bytes
of every executed micro-batch — ``stats["wire_bytes"]`` is a measured
quantity that reconciles exactly against the analytic
``inference.communication_cost`` formula (bytes are per row, so
coalescing changes message counts, never byte totals).

Requests larger than the top capacity are chunked into parts and
reassembled in arrival order. Where the reference compiles one program
per (route, capacity), PyTorch runs eagerly: a CUDA graph per (route,
capacity) is the analogue, listed in ROADMAP.md for a later change.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import codec as wire
from repro_torch.core import inference
from repro_torch.core.encoders import EncoderConfig
from repro_torch.core.inference import (Route, ROUTES, communication_cost,
                                        request_rows, route_for, route_scores)

_SENTINEL = object()  # end-of-stream marker for the assembly queue


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine shape/wire policy.

    ``capacities`` is the padded-batch ladder (ascending); its maximum
    is also the micro-batch coalescing limit. The ladder floors at 2
    (``inference.MIN_COMPILED_ROWS``): a 1-row batch runs matrix-vector
    products whose reduction order differs from every batched shape.
    ``codec`` applies the wire codec to the VFL route's messages.
    ``window`` is how many requests one assembly pass may coalesce;
    ``prefetch`` is how many assembled windows the worker may stage
    ahead (0 = synchronous assembly). ``record_wire`` keeps each lossy
    VFL row's message codes in ``ServedResult.wire`` (a check that
    attributes score differences to codec decisions reads them).
    """

    capacities: tuple = (2, 4, 16, 64)
    codec: str = "none"
    topk_frac: float = 0.25
    window: int = 32
    prefetch: int = 2
    record_wire: bool = False

    def __post_init__(self):
        caps = tuple(int(c) for c in self.capacities)
        if not caps or list(caps) != sorted(set(caps)):
            raise ValueError(f"capacities must be ascending unique ints, got {self.capacities}")
        if caps[0] < inference.MIN_COMPILED_ROWS:
            raise ValueError(
                f"capacities floor at {inference.MIN_COMPILED_ROWS} (got "
                f"{caps[0]}): 1-row batches run matrix-vector products "
                "whose reduction order differs from every batched shape")
        object.__setattr__(self, "capacities", caps)
        if self.codec not in wire.CODECS:
            raise ValueError(f"codec {self.codec!r} not in {wire.CODECS}")
        if self.window < 1:
            raise ValueError(f"window={self.window} must be >= 1")
        if self.prefetch < 0:
            raise ValueError(f"prefetch={self.prefetch} must be >= 0")


def bucket_for(n: int, capacities: tuple) -> int:
    """Smallest configured capacity holding ``n`` rows."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    for c in capacities:
        if n <= c:
            return c
    raise ValueError(f"n={n} rows exceed the top capacity {capacities[-1]}; "
                     "chunk before bucketing")


@dataclasses.dataclass
class ServedResult:
    """One completed request.

    ``messages``/``bytes`` are the request's own logical network cost
    (``communication_cost`` of its rows; 0 on local routes) — what this
    request would cost served alone. The engine's actual coalesced wire
    traffic is metered in ``ServingEngine.stats`` (same byte total,
    fewer messages).
    """

    index: int
    scores: torch.Tensor
    route: Route
    messages: int
    bytes: int
    latency_s: float
    wire: torch.Tensor | None = None  # as PredictResult.wire


# One part of one request inside an assembly window: requests larger
# than the top capacity are split into parts, served independently, and
# reassembled in offset order.
@dataclasses.dataclass
class _Part:
    index: int  # request index in the stream
    offset: int  # row offset inside the request
    x_a: np.ndarray | None
    x_b: np.ndarray | None

    @property
    def rows(self) -> int:
        return len(self.x_a) if self.x_a is not None else len(self.x_b)


@dataclasses.dataclass
class _Batch:
    """One padded micro-batch ready to execute: static (route, cap)
    shape, numpy host buffers, and the spans mapping padded rows back to
    request parts."""

    route: Route
    cap: int
    x_a: np.ndarray | None
    x_b: np.ndarray | None
    mask: np.ndarray  # (cap,) float 1=live 0=padding
    spans: list  # [(index, offset, start_row, n_rows)]
    n_live: int


class ServingEngine:
    """Batched request engine over one client's blended models, on
    ``device`` (CUDA when None; the models must live there).

    ``server_gmv`` (the VFL server head) is only needed when the stream
    may carry ``vfl=True`` requests. ``stats`` accumulates across calls.
    """

    def __init__(self, models: dict, ecfg: EncoderConfig, kind: str, *,
                 server_gmv: dict | None = None,
                 cfg: ServingConfig | None = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
        self.models = models
        self.ecfg = ecfg
        self.kind = kind
        self.server_gmv = server_gmv
        self.cfg = cfg if cfg is not None else ServingConfig()
        self._codec = wire.make_codec(self.cfg.codec, self.cfg.topk_frac)
        self.stats = {
            "requests": 0, "rows": 0, "batches": 0,
            "batches_by_route": {r.value: 0 for r in ROUTES},
            "wire_messages": 0, "wire_bytes": 0,
            "build_seconds": 0.0, "stall_seconds": 0.0,
            "execute_seconds": 0.0,
        }

    # ------------------------------------------------- window assembly ----

    def _plan_window(self, window: list) -> tuple:
        """Assemble one window of (index, request) into padded
        micro-batches (host-side numpy only — runs on the worker
        thread). Returns (meta, batches): meta maps request index to
        (route, n_parts, rows)."""
        top = self.cfg.capacities[-1]
        parts_by_route: dict = {r: [] for r in ROUTES}
        meta: dict = {}
        for index, req in window:
            route = route_for(req)
            if route is Route.VFL_FALLBACK and self.server_gmv is None:
                raise ValueError("stream carries vfl=True requests but the "
                                 "engine has no server_gmv head")
            n = request_rows(req)
            n_parts = 0
            for off in range(0, n, top):
                end = min(off + top, n)
                parts_by_route[route].append(_Part(
                    index, off,
                    None if req.x_a is None else np.asarray(req.x_a[off:end]),
                    None if req.x_b is None else np.asarray(req.x_b[off:end])))
                n_parts += 1
            meta[index] = (route, n_parts, n)

        batches = []
        for route in ROUTES:
            cur, cur_rows = [], 0
            for part in parts_by_route[route]:
                if cur and cur_rows + part.rows > top:
                    batches.append(self._pack(route, cur, cur_rows))
                    cur, cur_rows = [], 0
                cur.append(part)
                cur_rows += part.rows
            if cur:
                batches.append(self._pack(route, cur, cur_rows))
        return meta, batches

    def _pack(self, route: Route, parts: list, n_live: int) -> _Batch:
        """Pad one coalesced run of same-route parts up to its capacity
        bucket. Padding rows are zeros with mask 0 — under the per-row
        wire codec they're independent messages, so they never perturb
        the live rows' scores."""
        cap = bucket_for(n_live, self.cfg.capacities)

        def pad(blocks):
            first = blocks[0]
            out = np.zeros((cap,) + first.shape[1:], first.dtype)
            row = 0
            for b in blocks:
                out[row:row + len(b)] = b
                row += len(b)
            return out

        x_a = pad([p.x_a for p in parts]) if parts[0].x_a is not None else None
        x_b = pad([p.x_b for p in parts]) if parts[0].x_b is not None else None
        mask = np.zeros(cap, np.float32)
        mask[:n_live] = 1.0
        spans, row = [], 0
        for p in parts:
            spans.append((p.index, p.offset, row, p.rows))
            row += p.rows
        return _Batch(route, cap, x_a, x_b, mask, spans, n_live)

    # -------------------------------------------------------- execution ---

    def _execute(self, batch: _Batch) -> tuple:
        """Run one padded micro-batch on the device and meter the wire
        traffic it actually generated. Returns (scores, wire codes or
        None)."""
        def to_dev(x):
            return None if x is None else torch.from_numpy(x).to(self.device)

        t0 = time.perf_counter()
        x_a, x_b = to_dev(batch.x_a), to_dev(batch.x_b)
        mask = to_dev(batch.mask)
        vfl = batch.route is Route.VFL_FALLBACK
        log = [] if self.cfg.record_wire else None
        with torch.no_grad():
            s = route_scores(
                self.models, batch.route, x_a, x_b, self.ecfg, self.kind,
                server_gmv=self.server_gmv if vfl else None,
                codec=self._codec if vfl and self._codec.enabled else None,
                wire_log=log)
            scores = s * mask[:, None]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["execute_seconds"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["batches_by_route"][batch.route.value] += 1
        self.stats["rows"] += batch.n_live
        if vfl:
            # Measured bytes: this micro-batch moved n_live per-row
            # feature messages up (x2) and score rows down, priced by
            # the wire codec — the quantity the analytic
            # communication_cost formula must reconcile against.
            cost = communication_cost(batch.n_live, self.ecfg.d_hidden,
                                      "vfl", int(scores.shape[-1]),
                                      codec=self._codec)
            self.stats["wire_messages"] += cost["messages"]
            self.stats["wire_bytes"] += cost["bytes"]
        return scores, (log[0] if log else None)

    def _request_cost(self, route: Route, rows: int, out_dim: int) -> tuple:
        if route is not Route.VFL_FALLBACK:
            return 0, 0
        cost = communication_cost(rows, self.ecfg.d_hidden, "vfl", out_dim,
                                  codec=self._codec)
        return cost["messages"], cost["bytes"]

    def _serve_window(self, meta: dict, batches: list):
        """Execute one assembled window; yield each request's
        ServedResult as its last part completes."""
        t_w0 = time.perf_counter()
        # index -> offset -> (scores, wire codes or None)
        pending = {index: {} for index in meta}
        for batch in batches:
            scores, codes = self._execute(batch)
            for index, offset, start, n in batch.spans:
                pending[index][offset] = (
                    scores[start:start + n],
                    None if codes is None else codes[start:start + n])
                route, n_parts, rows = meta[index]
                if len(pending[index]) == n_parts:
                    parts = pending.pop(index)
                    got = [parts[k] for k in sorted(parts)]
                    full = (got[0][0] if n_parts == 1 else
                            torch.cat([g[0] for g in got]))
                    codes_full = (None if got[0][1] is None
                                  else torch.cat([g[1] for g in got]))
                    msgs, nbytes = self._request_cost(
                        route, rows, int(full.shape[-1]))
                    self.stats["requests"] += 1
                    yield ServedResult(index, full, route, msgs, nbytes,
                                       time.perf_counter() - t_w0, codes_full)

    # -------------------------------------------------------- public API --

    def serve_stream(self, requests):
        """Serve an iterable of ``InferenceRequest``s, yielding
        ``ServedResult``s in completion order (same-window requests can
        reorder across routes; use ``run`` for stream-order results).

        Window assembly (routing + chunking + padding; pure numpy) runs
        on a daemon worker thread staging up to ``cfg.prefetch`` windows
        ahead of device execution. An assembly error (e.g. a no-modality
        request) is re-raised here, not swallowed.
        """
        def windows():
            buf = []
            for index, req in enumerate(requests):
                buf.append((index, req))
                if len(buf) >= self.cfg.window:
                    yield buf
                    buf = []
            if buf:
                yield buf

        if self.cfg.prefetch <= 0:
            for win in windows():
                t0 = time.perf_counter()
                plan = self._plan_window(win)
                self.stats["build_seconds"] += time.perf_counter() - t0
                yield from self._serve_window(*plan)
            return

        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
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
                for win in windows():
                    t0 = time.perf_counter()
                    plan = self._plan_window(win)
                    self.stats["build_seconds"] += time.perf_counter() - t0
                    if stop_evt.is_set() or not _feed(plan):
                        return
                _feed(_SENTINEL)
            except BaseException as e:  # surface assembly errors to the
                _feed(e)  # consumer instead of hanging it on q.get()

        t = threading.Thread(target=worker, daemon=True,
                             name="serving-engine-assembly")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stats["stall_seconds"] += time.perf_counter() - t0
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield from self._serve_window(*item)
        finally:
            stop_evt.set()

    def run(self, requests) -> list:
        """Serve a request list; results in stream order."""
        return sorted(self.serve_stream(list(requests)),
                      key=lambda r: r.index)
