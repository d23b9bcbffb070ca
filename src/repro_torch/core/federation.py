"""BlendFL federation — Algorithm 1 over in-host clients (port of
``src/repro/core/federation.py``).

One ``round`` is the paper's training epoch:

    1. local unimodal training on *partial* data        (lines 3-8)
    2. split (VFL) training on *fragmented* data        (lines 9-23)
    3. local multimodal training on *paired* data       (lines 24-29)
    4. BlendAvg aggregation + broadcast                 (lines 30-32)

Every phase's math lives in ``repro_torch.core.engine`` over stacked
client trees (a leading ``C`` axis, ragged per-client data padded to
static shapes with per-row masks). This class builds the padded stacked
batches once at init, threads (models, optimizer state) through the
engine's phases each round, and runs the server-side BlendAvg scoring
(AUROC/AUPRC on the representative validation set, a host metric); the
weighted blend goes through the engine's blend kernel.

Partial participation (``FedConfig.n_sampled`` = K > 0): each round a
host-side participation policy (``FedConfig.policy``,
``repro_torch.core.schedule``) picks K of the C clients from the
telemetry (round, ``last_round``, omega EMA, participation counts, row
counts), drawing from ``host_rng``, a ``np.random.default_rng(cfg.seed)``
as in the reference, so that both pick the same ids. Their rows of the
stacked models, optimizer state and batches are gathered to (K, ...)
trees (``core.state``), trained, and the moments scattered back. The VFL
alignment keeps its row count; rows whose owner was not sampled get row
weight 0. With ``FedConfig.async_mode`` only the participants receive
the broadcast (stragglers keep stale weights, tracked by ``last_round``),
and a candidate trained from an s-rounds-old base has its Eq. 9-10 omega
damped by (1 + s)^-``core.blendavg.STALENESS_EXP``.

Strategies (``FedConfig.strategy``, ``core.aggregate``): blendavg,
fedavg, fedprox, scaffold and the robust median, trimmed_mean and krum,
each with an optional server optimizer (adam, momentum) on the blended
delta.

Shuffles: each phase takes its per-client row orders from ``perms``, a
callable ``perms(phase, n_clients, n_rows)`` that returns, for
``phase="unimodal"``, a pair of (n_clients, n_rows) index arrays
(modality A, then B) and, for ``phase="paired"``, one; ``n_clients`` is
K in a sampled round. The default draws them with ``torch.randperm``
from a CPU ``torch.Generator`` seeded with ``cfg.seed``; a parity test
passes the reference's draws instead.

Every encoder type trains (``EncoderConfig.enc_type``): ``mlp``,
``recurrent`` (the sLSTM cell) and ``transformer`` (flash attention), in
full, sampled and async rounds under every strategy. Each phase step
runs one forward kernel launch for all C (or K) clients' encoders of a
modality, and its backward kernels (``kernels/slstm_cell/slstm_cell_bwd``,
``kernels/flash_attention/flash_attention_bwd``) carry the gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_map, tree_unstack
from repro_torch.convert import params_to_device
from repro_torch.core import aggregate as strategies
from repro_torch.core import codec as wire
from repro_torch.core import schedule, vfl
from repro_torch.core import state as rstate
from repro_torch.core.blendavg import blendavg_weights
from repro_torch.core.schedule import EMA_BETA
from repro_torch.core.encoders import (
    EncoderConfig,
    encoder_apply,
    fusion_apply,
    init_client_models,
    task_scores,
)
from repro_torch.core.engine import (
    CLIENT_GROUPS,
    EngineConfig,
    RoundEngine,
    check_trainable,
    stack_with,
)
from repro_torch.core.partitioner import ClientData, ModalView, fragmented_overlap
from repro_torch.data.synthetic import SyntheticMultimodal, TaskSpec
from repro_torch.metrics import auprc, auroc
from repro_torch.models.common import dense


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int = 3
    rounds: int = 20
    local_epochs: int = 1  # local passes between aggregations (Fig. 2 x-axis)
    batch_size: int = 64
    lr: float = 1e-3
    optimizer: str = "sgd"  # sgd | adamw
    momentum: float = 0.0  # sgd momentum
    weight_decay: float = 0.0  # adamw decoupled weight decay
    schedule: str = "constant"  # constant | cosine (over all optimizer steps)
    # Aggregation strategy (``core.aggregate``): blendavg | fedavg |
    # fedprox | scaffold | median | trimmed_mean | krum.
    strategy: str = "blendavg"
    fedprox_mu: float = 0.0
    # Server-side optimizer on the blended delta, before broadcast.
    server_opt: str = "none"  # none | adam | momentum
    server_lr: float = 1.0
    n_malicious: int = 1  # the robust reducers' assumed attacker budget f
    # Which local rows feed phase-1 unimodal training: "all" (every
    # locally held x_m row) or "partial" (only the partial(D_m) subset).
    unimodal_data: str = "all"  # all | partial
    metric: str = "auroc"
    seed: int = 0
    n_sampled: int = 0  # K-of-C sampling; 0 = full participation
    # Async rounds (requires n_sampled): only sampled clients receive the
    # broadcast; the rest keep stale weights and their later candidates
    # get staleness-damped omegas.
    async_mode: bool = False
    policy: str = "uniform"  # participation policy (core.schedule)
    codec: str = "none"  # none | int8 | topk | int8_topk
    topk_frac: float = 0.25  # entries kept per leaf by sparsifying codecs

    def __post_init__(self):
        k = self.n_sampled or self.n_clients
        f = self.n_malicious
        if self.strategy == "krum" and k < f + 3:
            raise ValueError(
                f"krum needs at least n_malicious + 3 = {f + 3} candidates "
                f"per round, got K={k}")
        if self.strategy == "trimmed_mean" and k < 2 * f + 1:
            raise ValueError(
                f"trimmed_mean needs at least 2 * n_malicious + 1 = "
                f"{2 * f + 1} candidates per round, got K={k}")

    @property
    def strategy_cfg(self) -> strategies.StrategyConfig:
        return strategies.make_strategy(self.strategy, self.fedprox_mu,
                                        self.server_opt, self.server_lr,
                                        self.n_malicious)


# ------------------------------------------------------------- evaluation --

def _metric_fn(name: str) -> Callable:
    return {"auroc": auroc, "auprc": auprc}[name]


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def eval_unimodal(f, g, x, y, ecfg: EncoderConfig, kind: str, metric: str = "auroc"):
    dev = g["w"].device
    scores = task_scores(dense(g, encoder_apply(f, _on(x, dev), ecfg)), kind)
    return float(_metric_fn(metric)(np.asarray(y), scores.cpu().numpy()))


@torch.no_grad()
def eval_multimodal(f_a, f_b, g_m, x_a, x_b, y, ecfg: EncoderConfig, kind: str,
                    metric: str = "auroc"):
    dev = g_m["out"]["w"].device
    h_a = encoder_apply(f_a, _on(x_a, dev), ecfg)
    h_b = encoder_apply(f_b, _on(x_b, dev), ecfg)
    scores = task_scores(fusion_apply(g_m, h_a, h_b), kind)
    return float(_metric_fn(metric)(np.asarray(y), scores.cpu().numpy()))


# --------------------------------------------- stacked padded data builds --

def _pad_rows(n_max: int, batch_size: int) -> int:
    """Static padded row count: a positive multiple of the batch size."""
    b = max(1, batch_size)
    return max(b, b * math.ceil(max(n_max, 1) / b))


def _stack_views(views: list[ModalView], n_pad: int, seq: int, feat: int,
                 out_dim: int, device):
    """list of ragged per-client views -> x (C,n_pad,seq,feat), y, mask
    on ``device``."""
    c = len(views)
    x = np.zeros((c, n_pad, seq, feat), np.float32)
    y = np.zeros((c, n_pad, out_dim), np.float32)
    m = np.zeros((c, n_pad), np.float32)
    for k, v in enumerate(views):
        n = len(v)
        if n:
            x[k, :n] = v.x
            y[k, :n] = v.y
            m[k, :n] = 1.0
    return _on(x, device), _on(y, device), _on(m, device)


def _build_unimodal_data(clients: list[ClientData], cfg: FedConfig,
                         spec: TaskSpec, device):
    def view(cd, side):
        if cfg.unimodal_data == "all":
            return cd.all_a() if side == "a" else cd.all_b()
        return cd.partial_a if side == "a" else cd.partial_b

    va = [view(cd, "a") for cd in clients]
    vb = [view(cd, "b") for cd in clients]
    n_pad = _pad_rows(max(max(len(v) for v in va), max(len(v) for v in vb)),
                      cfg.batch_size)
    xa, ya, ma = _stack_views(va, n_pad, spec.seq_a, spec.feat_a, spec.out_dim,
                              device)
    xb, yb, mb = _stack_views(vb, n_pad, spec.seq_b, spec.feat_b, spec.out_dim,
                              device)
    return {"xa": xa, "ya": ya, "ma": ma, "xb": xb, "yb": yb, "mb": mb}


def _build_paired_data(clients: list[ClientData], cfg: FedConfig,
                       spec: TaskSpec, device):
    if not any(cd.has_paired for cd in clients):
        return None
    n_pad = _pad_rows(max(len(cd.paired_a) for cd in clients), cfg.batch_size)
    xa, ya, m = _stack_views([cd.paired_a for cd in clients], n_pad,
                             spec.seq_a, spec.feat_a, spec.out_dim, device)
    xb, _, _ = _stack_views([cd.paired_b for cd in clients], n_pad,
                            spec.seq_b, spec.feat_b, spec.out_dim, device)
    return {"xa": xa, "xb": xb, "y": ya, "m": m}


def _build_vfl_data(clients: list[ClientData], spec: TaskSpec, device):
    """Stack fragmented rows per owner + precompute the server alignment
    (PSI stand-in) as gather indices into the flattened (C*Nf) latent rows.

    Only rows in the cross-client overlap are kept: rows whose partner
    modality never arrived can't train. Returns (device batch, host
    alignment metadata), or (None, None) when no row aligns; the metadata
    (numpy gather indices and per-side padded row counts) lets a sampled
    round remap the alignment onto the gathered K-client layout.
    """
    c = len(clients)
    overlap = fragmented_overlap(clients)

    def keep(view):
        sel = np.isin(view.ids, overlap)
        return ModalView(view.x[sel], view.ids[sel], view.y[sel])

    fa = [keep(cd.frag_a) for cd in clients]
    fb = [keep(cd.frag_b) for cd in clients]
    nfa = max(max((len(v) for v in fa), default=0), 1)
    nfb = max(max((len(v) for v in fb), default=0), 1)
    xa, ya, _ = _stack_views(fa, nfa, spec.seq_a, spec.feat_a, spec.out_dim,
                             device)
    xb, _, _ = _stack_views(fb, nfb, spec.seq_b, spec.feat_b, spec.out_dim,
                            device)
    ids_a = np.full(c * nfa, -1, np.int64)
    ids_b = np.full(c * nfb, -1, np.int64)
    for k in range(c):
        ids_a[k * nfa : k * nfa + len(fa[k])] = fa[k].ids
        ids_b[k * nfb : k * nfb + len(fb[k])] = fb[k].ids
    pos_a = np.nonzero(ids_a >= 0)[0]
    pos_b = np.nonzero(ids_b >= 0)[0]
    _, ia, ib = vfl.align_by_id(ids_a[pos_a], ids_b[pos_b])
    if len(ia) == 0:
        return None, None
    gather_a = pos_a[ia]
    gather_b = pos_b[ib]
    part_a = np.zeros(c, bool)
    part_b = np.zeros(c, bool)
    part_a[np.unique(gather_a // nfa)] = True
    part_b[np.unique(gather_b // nfb)] = True
    batch = {"xa": xa, "xb": xb,
             "gather_a": torch.as_tensor(gather_a, device=device),
             "gather_b": torch.as_tensor(gather_b, device=device),
             "y": ya.reshape(c * nfa, -1)[torch.as_tensor(gather_a, device=device)],
             "part_a": torch.as_tensor(part_a, device=device),
             "part_b": torch.as_tensor(part_b, device=device)}
    host = {"gather_a": gather_a, "gather_b": gather_b, "nfa": nfa, "nfb": nfb}
    return batch, host


def generator_perms(seed: int) -> Callable:
    """The default permutation source: per-client ``torch.randperm`` draws
    from a CPU generator seeded with ``seed`` (see the module docstring)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(n_clients, n_rows):
        return torch.stack([torch.randperm(n_rows, generator=gen)
                            for _ in range(n_clients)])

    def perms(phase: str, n_clients: int, n_rows: int):
        if phase == "unimodal":
            return draw(n_clients, n_rows), draw(n_clients, n_rows)
        return draw(n_clients, n_rows)

    return perms


# -------------------------------------------------------------- federation --

@dataclasses.dataclass
class Federation:
    """Mutable federation state: stacked clients + the BlendFL server."""

    cfg: FedConfig
    spec: TaskSpec
    ecfg: EncoderConfig
    clients: list  # list[ClientData]
    engine: RoundEngine
    stacked: dict  # stacked client models {f_A, f_B, g_A, g_B, g_M}, leading C
    opt_state: dict  # stacked per-client optimizer state
    global_models: dict  # blended {f_A, f_B, g_A, g_B, g_M}
    server_gmv: dict  # g_M^v split-training head at the server
    srv_opt_state: dict  # server-head optimizer state
    val: SyntheticMultimodal  # server-side representative validation set
    data: dict  # device-resident padded stacked batches per phase
    device: torch.device
    perms: Callable  # perms(phase, n_clients, n_rows): per-client row orders
    # partial-participation round state
    host_rng: np.random.Generator = None  # host-side client-sampling RNG
    last_round: np.ndarray = None  # (C,) round each client last synced
    round_no: int = 0  # index of the NEXT round to run
    # participation-policy telemetry (core.schedule): EMA of each
    # client's BlendAvg omega and participation counts, updated every
    # aggregation
    policy_obj: object = None  # schedule.Policy
    omega_ema: np.ndarray = None  # (C,) float64
    part_count: np.ndarray = None  # (C,) int64
    # wire-codec error-feedback residuals (None when cfg.codec == "none"):
    # stacked per-client uplink rows + one server-side downlink tree
    resid_up: dict = None
    resid_down: dict = None
    # aggregation-strategy state (None for stateless strategies):
    # SCAFFOLD's c_global / c_local (stacked) and/or the server
    # optimizer's moments under "srv"
    strat_state: dict = None
    # optimizer steps each model group takes a round (SCAFFOLD's
    # Option-II 1/(steps*lr) scaling)
    scaffold_steps: dict = None

    @property
    def models(self) -> list[dict]:
        """Per-client model dicts — a read-only snapshot of ``stacked``."""
        return tree_unstack(self.stacked, self.cfg.n_clients)

    @staticmethod
    def init(gen: torch.Generator, cfg: FedConfig, spec: TaskSpec,
             ecfg: EncoderConfig, clients: list, val: SyntheticMultimodal, *,
             device=None, base=None, perms: Callable | None = None
             ) -> "Federation":
        """``gen`` draws the initial models unless ``base`` (a tree of
        numpy arrays or tensors keyed like the models) gives them.
        ``device``: CUDA when None (raises without it). ``perms``: the
        permutation source (default ``generator_perms(cfg.seed)``).
        Raises ``ValueError`` for an unknown encoder type."""
        check_trainable(ecfg)
        if cfg.n_sampled < 0 or cfg.n_sampled > cfg.n_clients:
            raise ValueError(
                f"n_sampled={cfg.n_sampled} must be in [0, n_clients]")
        if cfg.async_mode and not cfg.n_sampled:
            raise ValueError("async_mode requires n_sampled > 0 (with full "
                             "participation every candidate is fresh)")
        if cfg.policy != "uniform" and not cfg.n_sampled:
            raise ValueError(f"policy={cfg.policy!r} requires n_sampled > 0 "
                             "(full participation has nothing to schedule)")
        # validates the policy name even when n_sampled == 0
        policy_obj = schedule.make_policy(cfg.policy, cfg.n_clients,
                                          cfg.n_sampled or cfg.n_clients)
        scfg = cfg.strategy_cfg
        device = resolve_device(device)
        if base is None:
            base = init_client_models(gen, spec, ecfg, device=device)
        else:
            base = params_to_device(base, device)
        vfl_batch, vfl_host = _build_vfl_data(clients, spec, device)
        data = {
            "uni": _build_unimodal_data(clients, cfg, spec, device),
            "paired": _build_paired_data(clients, cfg, spec, device),
            "vfl": vfl_batch,
            "vfl_host": vfl_host,
            "val": {"x_a": _on(val.x_a, device), "x_b": _on(val.x_b, device)},
            # the server head's FedAvg weight (Eq. 8 candidate)
            "n_overlap": len(fragmented_overlap(clients)),
        }
        # optimizer steps a round: encoders step in all three phases,
        # unimodal heads in phase 1, the fusion head in phase 3 (one step
        # a minibatch; the VFL exchange is one full-batch step)
        nb_uni = data["uni"]["ma"].shape[1] // cfg.batch_size
        nb_paired = (data["paired"]["m"].shape[1] // cfg.batch_size
                     if data["paired"] is not None else 0)
        nb_vfl = 1 if data["vfl"] is not None else 0
        engine = RoundEngine(
            EngineConfig(ecfg=ecfg, kind=spec.kind, optimizer=cfg.optimizer,
                         lr=cfg.lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay, schedule=cfg.schedule,
                         total_steps=(cfg.rounds * cfg.local_epochs
                                      * (nb_uni + nb_paired + nb_vfl)),
                         # the server head steps once per epoch (one
                         # full-batch VFL exchange), not once per minibatch
                         server_total_steps=cfg.rounds * cfg.local_epochs,
                         codec=wire.make_codec(cfg.codec, cfg.topk_frac),
                         strategy=scfg),
            cfg.batch_size)
        e = float(cfg.local_epochs)
        scaffold_steps = {
            "f_A": e * (nb_uni + nb_vfl + nb_paired),
            "f_B": e * (nb_uni + nb_vfl + nb_paired),
            "g_A": e * nb_uni, "g_B": e * nb_uni, "g_M": e * nb_paired,
        }
        # all clients start from the same global init (standard FL practice)
        stacked = engine.fns.broadcast(base, cfg.n_clients)
        groups = {k: base[k] for k in CLIENT_GROUPS}
        codec_on = cfg.codec != "none"
        return Federation(
            cfg=cfg, spec=spec, ecfg=ecfg, clients=clients, engine=engine,
            stacked=stacked, opt_state=engine.init_opt_state(stacked),
            global_models=dict(base),
            server_gmv=tree_map(torch.clone, base["g_M"]),
            srv_opt_state=engine.init_server_opt_state(base["g_M"]),
            val=val, data=data, device=device,
            perms=perms if perms is not None else generator_perms(cfg.seed),
            host_rng=np.random.default_rng(cfg.seed),
            last_round=np.full(cfg.n_clients, -1, np.int64),
            policy_obj=policy_obj,
            omega_ema=np.zeros(cfg.n_clients),
            part_count=np.zeros(cfg.n_clients, np.int64),
            resid_up=wire.zeros_like_tree(stacked) if codec_on else None,
            resid_down=wire.zeros_like_tree(groups) if codec_on else None,
            strat_state=(strategies.init_state(
                scfg, {k: stacked[k] for k in CLIENT_GROUPS}, groups)
                if scfg.stateful else None),
            scaffold_steps=scaffold_steps,
        )

    def _index(self, p) -> torch.Tensor:
        return torch.tensor(np.asarray(p), dtype=torch.int64,
                            device=self.device)

    # ---- phases 1-3: one engine call each, on the round's (C or K) rows ----

    def _strat_block(self, anchor, idxd=None):
        """Per-participant strategy block for the phase functions (None
        for strategies with no client-side term): each participant's
        round-start weights anchor the FedProx pull; SCAFFOLD's c_local
        rows gather with the sampled ids like opt moments."""
        scfg = self.engine.cfg.strategy
        if not scfg.client_active:
            return None
        strat = {}
        if scfg.prox:
            strat["anchor"] = anchor
        if scfg.control:
            sub = strategies.sample_state(self.strat_state, idxd)
            strat["c_global"] = sub["c_global"]
            strat["c_local"] = sub["c_local"]
        return strat

    def _unimodal_phase(self, models, opt_state, data, strat=None):
        c, n_rows = data["ma"].shape
        idx_a, idx_b = self.perms("unimodal", c, n_rows)
        models, opt_state, loss = self.engine.unimodal_phase(
            models, opt_state, data, (self._index(idx_a), self._index(idx_b)),
            strat)
        return models, opt_state, float(loss)

    def _vfl_phase(self, models, opt_state, batch, strat=None):
        """Full-batch split exchange, exactly as Alg. 1: every aligned
        fragmented row goes through ONE joint forward/backward. The loss
        is NaN when no aligned row takes part."""
        if batch is None:
            return models, opt_state, float("nan")
        (models, self.server_gmv, opt_state, self.srv_opt_state,
         loss) = self.engine.vfl_phase(models, self.server_gmv, opt_state,
                                       self.srv_opt_state, batch, strat)
        return models, opt_state, float(loss)

    def _paired_phase(self, models, opt_state, data, strat=None):
        if data is None:
            return models, opt_state, float("nan")
        c, n_rows = data["m"].shape
        perm = self._index(self.perms("paired", c, n_rows))
        models, opt_state, loss = self.engine.paired_phase(
            models, opt_state, data, perm, strat)
        return models, opt_state, float(loss)

    # ---- phase 4: aggregation + broadcast ----

    def _candidate_metrics(self, scores_stacked, present) -> np.ndarray:
        """Host-side AUROC/AUPRC per stacked candidate; absent -> -inf."""
        metric = _metric_fn(self.cfg.metric)
        y = np.asarray(self.val.y)
        snp = scores_stacked.cpu().numpy()
        out = np.full(len(present), -np.inf)
        for k, p in enumerate(present):
            if p:
                out[k] = metric(y, snp[k])
        return out

    def _blend_group(self, global_tree, stacked_cands, scores, global_score,
                     fedavg_weights, staleness=None):
        """Shared scored/weighted blend dispatch; the blend itself runs
        through the engine's kernel path. BlendAvg consumes the Eq. 9-10
        scores, damped by ``staleness`` in async rounds (a group where no
        candidate improves keeps the global model and launches nothing);
        every other strategy consumes ``fedavg_weights`` (data volumes
        for fedavg / fedprox, uniform presence for scaffold). The robust
        strategies go to the engine's ``robust_update``: they treat every
        candidate as present. Returns (new_global, omega)."""
        fns = self.engine.fns
        scfg = self.engine.cfg.strategy
        if scfg.score_based:
            omega = blendavg_weights(scores, global_score, staleness=staleness)
            if omega.sum() == 0:  # no improvement anywhere -> keep global
                return global_tree, omega
            return fns.blend_stacked(stacked_cands, omega), omega
        w = np.asarray(fedavg_weights, np.float64)
        if scfg.robust:
            new, omega = fns.robust_update(global_tree, stacked_cands, w)
            return new, omega.cpu().numpy()
        new = fns.fedavg_update(global_tree, stacked_cands, w)
        tot = w.sum()
        return new, (w / tot if tot > 0 else w)

    def _aggregate(self, cand_stacked, idx=None, base=None) -> dict:
        """Phase 4 over the trained candidates ``cand_stacked`` (the C
        clients, or the K sampled ones with ``idx`` their ids: only they
        compete, and in async mode their omegas are staleness-damped).
        With a wire codec configured, ``base`` is the tree the
        participants started the round from: candidates arrive as decoded
        uplink deltas, and the new global leaves as a decoded downlink
        delta."""
        cfg, val, fns = self.cfg, self.val, self.engine.fns
        ecfg, kind, metric = self.ecfg, self.spec.kind, self.cfg.metric
        x_a, x_b = self.data["val"]["x_a"], self.data["val"]["x_b"]
        scfg = self.engine.cfg.strategy
        idxd = None if idx is None else self._index(idx)
        info = {}

        codec_on = self.resid_up is not None
        # the pre-round global tree: the codec's downlink reference and
        # the server optimizer's delta base
        prev_glob = {k: self.global_models[k] for k in CLIENT_GROUPS}
        if codec_on:
            resid = rstate.sample_block(
                "codec", {"resid_up": self.resid_up}, idxd)["resid_up"]
            cand_stacked, resid = self.engine.codec_uplink(cand_stacked, base,
                                                           resid)
            self.resid_up = rstate.scatter_block(
                "codec", {"resid_up": self.resid_up}, {"resid_up": resid},
                idxd)["resid_up"]
        sub_clients = (self.clients if idx is None
                       else [self.clients[i] for i in idx])
        stale = None
        if idx is not None:
            # rounds the candidate's base global model is behind; fresh
            # participants (synced at the end of the previous round) are 0
            stale = np.maximum(self.round_no - 1 - self.last_round[idx], 0)

        blend = scfg.score_based  # the weighted strategies never read scores
        for mod, x_val in (("A", x_a), ("B", x_b)):
            present = [cd.has_a if mod == "A" else cd.has_b for cd in sub_clients]
            if not any(present):
                continue
            cand = {"f": cand_stacked[f"f_{mod}"], "g": cand_stacked[f"g_{mod}"]}
            glob = {"f": self.global_models[f"f_{mod}"],
                    "g": self.global_models[f"g_{mod}"]}
            scores = gscore = ns = None
            if blend:
                scores = self._candidate_metrics(
                    self.engine.uni_scores(cand["f"], cand["g"], x_val), present)
                gscore = eval_unimodal(glob["f"], glob["g"], x_val, val.y, ecfg,
                                       kind, metric)
            else:  # scaffold: uniform over participants; else data volumes
                ns = [(1 if scfg.control else cd.n_samples()) if p else 0
                      for cd, p in zip(sub_clients, present)]
            blended, omega = self._blend_group(glob, cand, scores, gscore, ns,
                                               staleness=stale)
            info[f"omega_{mod}"] = omega
            self.global_models[f"f_{mod}"] = blended["f"]
            self.global_models[f"g_{mod}"] = blended["g"]

        # multimodal: participating client g_M heads + the server's g_M^v
        # (Eq. 8); the server head trains every round, so it is never stale
        present = [cd.has_paired for cd in sub_clients] + [True]
        cand = stack_with(cand_stacked["g_M"], self.server_gmv)
        f_a, f_b = self.global_models["f_A"], self.global_models["f_B"]
        scores = gscore = ns = None
        if blend:
            scores = self._candidate_metrics(
                self.engine.multi_scores(f_a, f_b, cand, x_a, x_b), present)
            gscore = eval_multimodal(f_a, f_b, self.global_models["g_M"],
                                     x_a, x_b, val.y, ecfg, kind, metric)
        elif scfg.control:  # present heads uniformly, the server's if any overlap
            ns = [1 if cd.has_paired else 0 for cd in sub_clients]
            ns.append(1 if self.data["n_overlap"] else 0)
        else:
            # paired counts per client, the server head carrying the VFL
            # overlap size — zero when no rows overlap
            ns = [len(cd.paired_a) if cd.has_paired else 0 for cd in sub_clients]
            ns.append(self.data["n_overlap"])
        stale_m = None if stale is None else np.append(stale, 0.0)
        blended, omega = self._blend_group(self.global_models["g_M"], cand,
                                           scores, gscore, ns, staleness=stale_m)
        info["omega_M"] = omega
        self.global_models["g_M"] = blended

        # server-side optimizer on the blended delta, before anything is
        # broadcast: clients (and the downlink codec) see the adjusted
        # global, and the server's g_M^v re-seeds from it
        if scfg.server_opt != "none":
            glob = {k: self.global_models[k] for k in CLIENT_GROUPS}
            glob, srv = self.engine.server_update(self.strat_state["srv"],
                                                  glob, prev_glob)
            self.strat_state = dict(self.strat_state, srv=srv)
            self.global_models.update(glob)
        # the server's split-training head re-seeds from the TRUE blend
        # (it never crosses a wire), codec or not
        gmv_true = self.global_models["g_M"]

        # wire codec, downlink leg: what the clients adopt is the blend
        # as decoded from the broadcast delta vs. the global they held
        if codec_on:
            glob = {k: self.global_models[k] for k in CLIENT_GROUPS}
            glob, self.resid_down = self.engine.codec_downlink(
                glob, prev_glob, self.resid_down)
            self.global_models.update(glob)

        # LocalUpdate: broadcast blended models back (line 32). Clients keep
        # their optimizer moments; only the weights are replaced. Async
        # rounds broadcast to the participants only.
        glob_groups = {k: self.global_models[k] for k in CLIENT_GROUPS}
        if idx is not None and cfg.async_mode:
            self.stacked = dict(rstate.scatter_block(
                "models", self.stacked, fns.broadcast(glob_groups, len(idx)),
                idxd))
            self.last_round[np.asarray(idx)] = self.round_no
        else:
            self.stacked = dict(fns.broadcast(glob_groups, cfg.n_clients))
            self.last_round[:] = self.round_no
        self.server_gmv = tree_map(torch.clone, gmv_true)

        # policy telemetry: fold this round's per-client omega (mean over
        # the heads that competed; omega_M's server slot excluded) into
        # the EMA at the participants' slots, count participation
        heads = [np.asarray(info[k], np.float64)
                 for k in ("omega_A", "omega_B") if k in info]
        heads.append(np.asarray(info["omega_M"], np.float64)[: len(sub_clients)])
        cli_omega = np.mean(np.stack(heads), axis=0)
        sel = np.arange(cfg.n_clients) if idx is None else np.asarray(idx)
        b = EMA_BETA
        self.omega_ema[sel] = b * self.omega_ema[sel] + (1 - b) * cli_omega
        self.part_count[sel] += 1
        return info

    def _scaffold_update(self, anchor, trained, idxd=None):
        """SCAFFOLD Option-II control-variate update on the TRUE trained
        weights (before any lossy uplink codec touches the candidates)."""
        if not self.engine.cfg.strategy.control:
            return
        st = self.strat_state
        cl = strategies.sample_state(st, idxd)["c_local"]
        k = self.cfg.n_clients if idxd is None else int(idxd.shape[0])
        new_cg, new_cl = self.engine.scaffold_round(
            st["c_global"], cl, anchor, trained, self.scaffold_steps,
            k / self.cfg.n_clients)
        self.strat_state = strategies.scatter_state(
            st, {**st, "c_global": new_cg, "c_local": new_cl}, idxd)

    # ---- K-of-C sampled rounds ----

    def _sampled_vfl_batch(self, idx: np.ndarray, idxd: torch.Tensor):
        """Remap the precomputed VFL alignment onto the gathered K-client
        layout. The aligned row count stays as it is: rows whose a- or
        b-side owner was not sampled keep their slot with row weight 0
        (and index 0). Returns None when no aligned row survives."""
        if self.data["vfl"] is None:
            return None
        host, full = self.data["vfl_host"], self.data["vfl"]
        nfa, nfb = host["nfa"], host["nfb"]
        ga, gb = host["gather_a"], host["gather_b"]
        k = len(idx)
        pos = np.full(self.cfg.n_clients, -1)
        pos[idx] = np.arange(k)
        oa, ob = ga // nfa, gb // nfb
        keep = (pos[oa] >= 0) & (pos[ob] >= 0)
        if not keep.any():
            return None
        dev = self.device
        return {
            "xa": rstate.sample_clients(full["xa"], idxd),
            "xb": rstate.sample_clients(full["xb"], idxd),
            "gather_a": self._index(np.where(keep, pos[oa] * nfa + ga % nfa, 0)),
            "gather_b": self._index(np.where(keep, pos[ob] * nfb + gb % nfb, 0)),
            "y": full["y"],
            "w": torch.as_tensor(keep.astype(np.float32), device=dev),
            "part_a": torch.as_tensor(
                np.bincount(pos[oa[keep]], minlength=k) > 0, device=dev),
            "part_b": torch.as_tensor(
                np.bincount(pos[ob[keep]], minlength=k) > 0, device=dev),
        }

    def _sched_telemetry(self) -> dict:
        """What the participation policy sees: round index, omega EMA,
        participation counts, last_round, and static data volumes."""
        return {"round": self.round_no, "last_round": self.last_round,
                "omega_ema": self.omega_ema, "part_count": self.part_count,
                "rows": np.asarray([cd.n_samples() for cd in self.clients],
                                   np.float64)}

    # ---- round / fit ----

    def round(self) -> dict:
        """One global training epoch (Algorithm 1 body). With
        ``cfg.n_sampled`` the policy picks the K ids from the telemetry,
        the round gathers those clients' stacked rows, runs the phases at
        leading axis K, scatters optimizer state back, and aggregates
        over the K candidates."""
        logs = {}
        idx = idxd = None
        if self.cfg.n_sampled:
            idx = self.policy_obj.select(self.host_rng, self._sched_telemetry())
            idxd = self._index(idx)
            logs["sampled"] = idx

        def rows(tree):
            return tree if tree is None or idxd is None else \
                rstate.sample_clients(tree, idxd)

        models = rows(self.stacked)
        # codec uplink base AND strategy anchor: the weights each
        # participant starts the round from
        base = models
        strat = self._strat_block(base, idxd)
        opt_state = rstate.sample_block("opt", self.opt_state, idxd)
        uni, paired = rows(self.data["uni"]), rows(self.data["paired"])
        vfl_batch = (self.data["vfl"] if idx is None
                     else self._sampled_vfl_batch(idx, idxd))
        for _ in range(self.cfg.local_epochs):
            models, opt_state, logs["loss_partial"] = self._unimodal_phase(
                models, opt_state, uni, strat)
            models, opt_state, logs["loss_vfl"] = self._vfl_phase(
                models, opt_state, vfl_batch, strat)
            models, opt_state, logs["loss_paired"] = self._paired_phase(
                models, opt_state, paired, strat)
        # moments ride home with their clients; the trained weights only
        # matter as aggregation candidates (broadcast decides what sticks)
        self.opt_state = rstate.scatter_block("opt", self.opt_state, opt_state,
                                              idxd)
        self._scaffold_update(base, models, idxd)
        logs.update(self._aggregate(models, idx=idx, base=base))
        self.round_no += 1
        return logs

    def fit(self, eval_every: int = 0, eval_fn: Callable | None = None) -> list[dict]:
        history = []
        for r in range(self.cfg.rounds):
            logs = self.round()
            logs["round"] = r
            if eval_every and eval_fn and (r + 1) % eval_every == 0:
                logs.update(eval_fn(self))
            history.append(logs)
        return history


def evaluate_global(fed: Federation, test: SyntheticMultimodal) -> dict:
    """Paper-style test metrics of the blended global models: multimodal +
    both unimodal heads, AUROC and AUPRC."""
    g, ecfg, kind = fed.global_models, fed.ecfg, fed.spec.kind
    out = {}
    for metric in ("auroc", "auprc"):
        out[f"multimodal_{metric}"] = eval_multimodal(
            g["f_A"], g["f_B"], g["g_M"], test.x_a, test.x_b, test.y, ecfg, kind, metric)
        out[f"uni_a_{metric}"] = eval_unimodal(
            g["f_A"], g["g_A"], test.x_a, test.y, ecfg, kind, metric)
        out[f"uni_b_{metric}"] = eval_unimodal(
            g["f_B"], g["g_B"], test.x_b, test.y, ecfg, kind, metric)
    return out
