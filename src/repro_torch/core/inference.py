"""Decentralized inference (paper contribution #2) — the typed request API
(port of ``src/repro/core/inference.py``).

After BlendFL training every client holds the blended ``f_A, f_B, g_A,
g_B, g_M``, so it serves predictions with whatever modalities a local
sample has, with no server round-trip:

    both modalities present  -> g_M(f_A(x_A), f_B(x_B))     Route.MULTIMODAL
    only A                   -> g_A(f_A(x_A))               Route.UNIMODAL_A
    only B                   -> g_B(f_B(x_B))               Route.UNIMODAL_B

``Route.VFL_FALLBACK`` is the conventional-VFL comparison path (SplitNN
style): features go up to the server head ``g_M^v`` and predictions come
down, one wire message per sample row, lossily round-tripped through
the wire codec when one is given.

``predict`` is the single typed entry point: it routes the request, runs
the forward on ``device`` and returns a ``PredictResult`` with the
scores, the ``Route`` and the network cost. The batched many-request
engine over the same forward is ``repro_torch.core.serving``.
``local_predict`` and ``vfl_server_inference`` are deprecated wrappers
over ``predict``.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import codec as wire
from repro_torch.core.encoders import (EncoderConfig, encoder_apply,
                                       fusion_apply, task_scores)
from repro_torch.models.common import dense


class Route(enum.Enum):
    """How a request is served, chosen from its available modalities."""

    MULTIMODAL = "multimodal"
    UNIMODAL_A = "unimodal_A"
    UNIMODAL_B = "unimodal_B"
    VFL_FALLBACK = "vfl_fallback"


# deterministic ordering for engines that bucket requests by route
ROUTES = (Route.MULTIMODAL, Route.UNIMODAL_A, Route.UNIMODAL_B,
          Route.VFL_FALLBACK)


@dataclasses.dataclass
class InferenceRequest:
    x_a: np.ndarray | None  # (B, S_a, F_a) or None if modality missing
    x_b: np.ndarray | None
    # vfl=True asks for conventional server-mediated (SplitNN) serving —
    # the fallback for a client that holds no blended heads. Needs both
    # modalities and a live server head.
    vfl: bool = False


@dataclasses.dataclass
class PredictResult:
    """One served request: scores plus how (and at what cost) it ran.

    ``messages``/``bytes`` are the network cost of THIS request served
    alone (0 for the local routes; 2 feature uploads + 1 score download
    for ``VFL_FALLBACK``, priced per sample row through the wire codec).
    """

    scores: torch.Tensor  # (B, out_dim) probability scores
    route: Route
    messages: int
    bytes: int
    # with record_wire on a lossy VFL request: (B, 2 * d_hidden + out_dim)
    # int16, each row's message codes (codec.message_codes) of its h_A
    # and h_B uploads and its score download; else None
    wire: torch.Tensor | None = None


def request_rows(req: InferenceRequest) -> int:
    """Sample rows a request carries (its present modalities must agree)."""
    na = None if req.x_a is None else len(req.x_a)
    nb = None if req.x_b is None else len(req.x_b)
    if na is not None and nb is not None and na != nb:
        raise ValueError(f"request modalities disagree on rows: x_a has "
                         f"{na}, x_b has {nb}")
    n = na if na is not None else nb
    if n is None:
        raise ValueError("request carries no modality")
    return n


def route_for(req: InferenceRequest) -> Route:
    """Route selection: VFL when asked for (and possible), else local by
    modality presence. Raises ``ValueError`` on an unservable request."""
    request_rows(req)  # raises on the no-modality / ragged cases
    if req.vfl:
        if req.x_a is None or req.x_b is None:
            raise ValueError(
                "VFL serving needs both parties: the server head fuses "
                "h_A and h_B, so a request missing a modality can only be "
                "served by the decentralized unimodal routes")
        return Route.VFL_FALLBACK
    if req.x_a is not None and req.x_b is not None:
        return Route.MULTIMODAL
    return Route.UNIMODAL_A if req.x_a is not None else Route.UNIMODAL_B


def route_scores(models: dict, route: Route, x_a, x_b, ecfg: EncoderConfig,
                 kind: str, *, server_gmv=None,
                 codec: wire.CodecConfig | None = None, wire_log=None):
    """Forward for one route — the one both ``predict`` and the serving
    engine run. The VFL route round-trips its feature uploads and score
    download through the wire codec (per-row messages:
    ``encode_decode_stacked`` gives every sample row its own scale and
    top-k threshold, so zero-padded rows never perturb live ones). A
    ``wire_log`` list gets the rows' message codes of the three messages
    appended, side by side, when the codec is on."""
    if route is Route.MULTIMODAL:
        h_a = encoder_apply(models["f_A"], x_a, ecfg)
        h_b = encoder_apply(models["f_B"], x_b, ecfg)
        return task_scores(fusion_apply(models["g_M"], h_a, h_b), kind)
    if route is Route.UNIMODAL_A:
        return task_scores(dense(models["g_A"], encoder_apply(models["f_A"], x_a, ecfg)), kind)
    if route is Route.UNIMODAL_B:
        return task_scores(dense(models["g_B"], encoder_apply(models["f_B"], x_b, ecfg)), kind)
    if route is Route.VFL_FALLBACK:
        h_a = encoder_apply(models["f_A"], x_a, ecfg)  # feature msg up
        h_b = encoder_apply(models["f_B"], x_b, ecfg)  # feature msg up
        lossy = codec is not None and codec.enabled
        codes = []
        if lossy:
            if wire_log is not None:
                codes += [wire.message_codes(h, codec) for h in (h_a, h_b)]
            h_a = wire.encode_decode_stacked(h_a, codec)
            h_b = wire.encode_decode_stacked(h_b, codec)
        scores = task_scores(fusion_apply(server_gmv, h_a, h_b), kind)
        if lossy:  # score msg down
            if wire_log is not None:
                codes.append(wire.message_codes(scores, codec))
                wire_log.append(torch.cat(codes, dim=1))
            scores = wire.encode_decode_stacked(scores, codec)
        return scores
    raise ValueError(f"unknown route {route!r}")


# Single-sample calls execute padded to 2 rows, as in the reference: a
# 1-row product is a matrix-vector product (gemv in cuBLAS, its own
# lowering in XLA) whose reduction order differs from the matrix-matrix
# products every batch >= 2 runs. The serving engine's capacity ladder
# floors at the same 2.
MIN_COMPILED_ROWS = 2


def predict(models: dict, req: InferenceRequest, ecfg: EncoderConfig,
            kind: str, *, server_gmv: dict | None = None,
            codec: wire.CodecConfig | str | None = None,
            device=None, record_wire: bool = False) -> PredictResult:
    """Serve one request on ``device`` (CUDA when None; the models must
    live there): route by available modalities, run the forward, report
    the network cost.

    ``server_gmv`` (the server's split-training head) is required only
    when the request asks for ``vfl=True``. ``codec`` (a name or
    ``CodecConfig``) applies the wire codec to the VFL route's messages —
    both the lossy payload round-trip and the byte pricing; local routes
    never touch the network. ``record_wire`` keeps each row's message
    codes in ``PredictResult.wire`` (a lossy VFL request only).
    """
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32
    route = route_for(req)
    if isinstance(codec, str):
        codec = wire.make_codec(codec)
    n = request_rows(req)
    pad = max(0, MIN_COMPILED_ROWS - n)

    def prep(x):
        if x is None:
            return None
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        # pad rows are sliced off below; they never mix into live rows
        # (all routes are row-parallel), so no mask is needed here
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x

    if route is Route.VFL_FALLBACK and server_gmv is None:
        raise ValueError("VFL serving needs the server head: pass "
                         "server_gmv= (see Federation.server_gmv)")
    # PyTorch runs eagerly: where the reference caches one jitted program
    # per (route, config, codec), this calls the forward directly
    log = [] if record_wire else None
    with torch.no_grad():
        scores = route_scores(models, route, prep(req.x_a), prep(req.x_b),
                              ecfg, kind, server_gmv=server_gmv,
                              codec=codec, wire_log=log)[:n]
    if route is Route.VFL_FALLBACK:
        cost = communication_cost(n, ecfg.d_hidden, "vfl",
                                  int(scores.shape[-1]), codec=codec)
        return PredictResult(scores, route, cost["messages"], cost["bytes"],
                             log[0][:n] if log else None)
    return PredictResult(scores, route, 0, 0)


def communication_cost(batch: int, d_hidden: int, mode: str, out_dim: int,
                       *, dtype_bytes: int = 4, codec=None) -> dict:
    """Analytic bytes over the network per inference batch.

    decentralized: 0 — the blended models are local.
    vfl: two feature uploads + one score download per batch, each sample
    row its own wire message (per-row scale/indices under a lossy codec —
    the same convention as ``codec.encode_decode_stacked``, and what the
    serving engine's measured byte counts reconcile against):

        bytes = batch * (2 * row_bytes(d_hidden) + row_bytes(out_dim))

    ``dtype_bytes`` sizes a dense payload value (4 = fp32 default, 2 =
    bf16 activations); ``codec`` (a ``CodecConfig`` or codec name) prices
    each row through the wire codec's format instead.
    """
    if mode == "decentralized":
        return {"messages": 0, "bytes": 0}
    if isinstance(codec, str):
        codec = wire.make_codec(codec)
    if codec is None:
        codec = wire.CodecConfig()  # "none": dense dtype_bytes payloads
    feat_bytes = 2 * batch * wire.leaf_payload_bytes(d_hidden, codec,
                                                     dtype_bytes)
    score_bytes = batch * wire.leaf_payload_bytes(out_dim, codec, dtype_bytes)
    return {"messages": 3, "bytes": feat_bytes + score_bytes}


# ------------------------------------------------- deprecated wrappers -----

def local_predict(models: dict, req: InferenceRequest, ecfg: EncoderConfig,
                  kind: str, *, device=None):
    """Deprecated: use ``predict`` (returns a typed ``PredictResult``)."""
    warnings.warn(
        "local_predict is deprecated: use repro_torch.core.inference.predict, "
        "which returns a PredictResult (scores / Route / messages / bytes)",
        DeprecationWarning, stacklevel=2)
    res = predict(models, dataclasses.replace(req, vfl=False), ecfg, kind,
                  device=device)
    return res.scores, res.route.value


def vfl_server_inference(client_models: dict, server_gmv: dict, req: InferenceRequest,
                         ecfg: EncoderConfig, kind: str, *, device=None):
    """Deprecated: use ``predict(..., server_gmv=...)`` on a request with
    ``vfl=True``."""
    warnings.warn(
        "vfl_server_inference is deprecated: use repro_torch.core.inference."
        "predict with InferenceRequest(vfl=True) and server_gmv=",
        DeprecationWarning, stacklevel=2)
    res = predict(client_models, dataclasses.replace(req, vfl=True), ecfg,
                  kind, server_gmv=server_gmv, device=device)
    return res.scores, res.messages
