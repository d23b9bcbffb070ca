"""BlendFL federation — Algorithm 1 over in-host clients, full
participation (port of ``src/repro/core/federation.py``).

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

Shuffles: each phase takes its per-client row orders from ``perms``, a
callable ``perms(phase, n_clients, n_rows)`` that returns, for
``phase="unimodal"``, a pair of (C, n_rows) index arrays (modality A,
then B) and, for ``phase="paired"``, one. The default draws them with
``torch.randperm`` from a CPU ``torch.Generator`` seeded with
``cfg.seed``; a parity test passes the reference's draws instead.

Not ported yet (ROADMAP.md, modules to port, item 9): K-of-C sampled
and async rounds, participation policies, and every strategy but
blendavg and fedavg; nor (item 17) training the ``recurrent`` and
``transformer`` encoders, which the port only serves. Asking for one
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_map, tree_unstack
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregate as strategies
from repro_torch.core import codec as wire
from repro_torch.core import vfl
from repro_torch.core.blendavg import blendavg_weights
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
    """The reference's federation configuration, less the knobs of what
    the port does not run (async staleness damping, the omega-EMA
    policy's beta, the robust reducers' ``n_malicious``, the server
    optimizer's rate) and the ``aggregator`` alias of ``strategy``."""

    n_clients: int = 3
    rounds: int = 20
    local_epochs: int = 1  # local passes between aggregations (Fig. 2 x-axis)
    batch_size: int = 64
    lr: float = 1e-3
    optimizer: str = "sgd"  # sgd | adamw
    momentum: float = 0.0  # sgd momentum
    weight_decay: float = 0.0  # adamw decoupled weight decay
    schedule: str = "constant"  # constant | cosine (over all optimizer steps)
    strategy: str = "blendavg"  # blendavg | fedavg (the rest raise)
    fedprox_mu: float = 0.0  # > 0 only with fedprox (which raises)
    server_opt: str = "none"  # none (adam | momentum raise)
    # Which local rows feed phase-1 unimodal training: "all" (every
    # locally held x_m row) or "partial" (only the partial(D_m) subset).
    unimodal_data: str = "all"  # all | partial
    metric: str = "auroc"
    seed: int = 0
    # K-of-C sampled and async rounds, and their participation policies,
    # are not ported: anything but these defaults raises at init.
    n_sampled: int = 0  # K-of-C sampling; 0 = full participation
    async_mode: bool = False
    policy: str = "uniform"
    codec: str = "none"  # none | int8 | topk | int8_topk
    topk_frac: float = 0.25  # entries kept per leaf by sparsifying codecs

    @property
    def strategy_cfg(self) -> strategies.StrategyConfig:
        return strategies.make_strategy(self.strategy, self.fedprox_mu,
                                        self.server_opt)


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
    modality never arrived can't train. Returns the device batch, or
    None when no row aligns.
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
        return None
    gather_a = pos_a[ia]
    gather_b = pos_b[ib]
    part_a = np.zeros(c, bool)
    part_b = np.zeros(c, bool)
    part_a[np.unique(gather_a // nfa)] = True
    part_b[np.unique(gather_b // nfb)] = True
    return {"xa": xa, "xb": xb,
            "gather_a": torch.as_tensor(gather_a, device=device),
            "gather_b": torch.as_tensor(gather_b, device=device),
            "y": ya.reshape(c * nfa, -1)[torch.as_tensor(gather_a, device=device)],
            "part_a": torch.as_tensor(part_a, device=device),
            "part_b": torch.as_tensor(part_b, device=device)}


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
    round_no: int = 0  # index of the NEXT round to run
    # wire-codec error-feedback residuals (None when cfg.codec == "none"):
    # stacked per-client uplink rows + one server-side downlink tree
    resid_up: dict = None
    resid_down: dict = None

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
        Raises ``NotImplementedError`` for an encoder type training does
        not run (``recurrent``, ``transformer``)."""
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
        if cfg.n_sampled:
            raise NotImplementedError(
                "K-of-C sampled and async rounds are not ported yet "
                "(ROADMAP.md, modules to port, item 9); use n_sampled=0")
        scfg = cfg.strategy_cfg  # raises for the strategies not ported
        device = resolve_device(device)
        if base is None:
            base = init_client_models(gen, spec, ecfg, device=device)
        else:
            base = params_from_numpy(tree_map(
                lambda x: x.detach().cpu().numpy()
                if isinstance(x, torch.Tensor) else x, base), device)
        data = {
            "uni": _build_unimodal_data(clients, cfg, spec, device),
            "paired": _build_paired_data(clients, cfg, spec, device),
            "vfl": _build_vfl_data(clients, spec, device),
            "val": {"x_a": _on(val.x_a, device), "x_b": _on(val.x_b, device)},
            # the server head's FedAvg weight (Eq. 8 candidate)
            "n_overlap": len(fragmented_overlap(clients)),
        }
        steps_per_epoch = (data["uni"]["ma"].shape[1] // cfg.batch_size
                           + (data["paired"]["m"].shape[1] // cfg.batch_size
                              if data["paired"] is not None else 0)
                           + (1 if data["vfl"] is not None else 0))
        engine = RoundEngine(
            EngineConfig(ecfg=ecfg, kind=spec.kind, optimizer=cfg.optimizer,
                         lr=cfg.lr, momentum=cfg.momentum,
                         weight_decay=cfg.weight_decay, schedule=cfg.schedule,
                         total_steps=cfg.rounds * cfg.local_epochs * steps_per_epoch,
                         # the server head steps once per epoch (one
                         # full-batch VFL exchange), not once per minibatch
                         server_total_steps=cfg.rounds * cfg.local_epochs,
                         codec=wire.make_codec(cfg.codec, cfg.topk_frac),
                         strategy=scfg),
            cfg.batch_size)
        # all clients start from the same global init (standard FL practice)
        stacked = engine.fns.broadcast(base, cfg.n_clients)
        codec_on = cfg.codec != "none"
        return Federation(
            cfg=cfg, spec=spec, ecfg=ecfg, clients=clients, engine=engine,
            stacked=stacked, opt_state=engine.init_opt_state(stacked),
            global_models=dict(base),
            server_gmv=tree_map(torch.clone, base["g_M"]),
            srv_opt_state=engine.init_server_opt_state(base["g_M"]),
            val=val, data=data, device=device,
            perms=perms if perms is not None else generator_perms(cfg.seed),
            resid_up=wire.zeros_like_tree(stacked) if codec_on else None,
            resid_down=(wire.zeros_like_tree(
                {k: base[k] for k in CLIENT_GROUPS}) if codec_on else None),
        )

    def _index(self, p) -> torch.Tensor:
        return torch.tensor(np.asarray(p), dtype=torch.int64,
                            device=self.device)

    # ---- phases 1-3: one engine call each ----

    def _unimodal_phase(self) -> float:
        c, n_rows = self.data["uni"]["ma"].shape
        idx_a, idx_b = self.perms("unimodal", c, n_rows)
        self.stacked, self.opt_state, loss = self.engine.unimodal_phase(
            self.stacked, self.opt_state, self.data["uni"],
            (self._index(idx_a), self._index(idx_b)))
        return float(loss)

    def _vfl_phase(self) -> float:
        """Full-batch split exchange, exactly as Alg. 1: every aligned
        fragmented row goes through ONE joint forward/backward."""
        if self.data["vfl"] is None:
            return float("nan")
        (self.stacked, self.server_gmv, self.opt_state, self.srv_opt_state,
         loss) = self.engine.vfl_phase(self.stacked, self.server_gmv,
                                       self.opt_state, self.srv_opt_state,
                                       self.data["vfl"])
        return float(loss)

    def _paired_phase(self) -> float:
        if self.data["paired"] is None:
            return float("nan")
        c, n_rows = self.data["paired"]["m"].shape
        perm = self._index(self.perms("paired", c, n_rows))
        self.stacked, self.opt_state, loss = self.engine.paired_phase(
            self.stacked, self.opt_state, self.data["paired"], perm)
        return float(loss)

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
                     fedavg_weights):
        """Shared scored/weighted blend dispatch; the blend itself runs
        through the engine's kernel path. BlendAvg consumes the Eq. 9-10
        scores (a group where no candidate improves keeps the global model
        and launches nothing); fedavg consumes the data-volume
        ``fedavg_weights``. Returns (new_global, omega)."""
        fns = self.engine.fns
        if self.engine.cfg.strategy.score_based:
            omega = blendavg_weights(scores, global_score)
            if omega.sum() == 0:  # no improvement anywhere -> keep global
                return global_tree, omega
            return fns.blend_stacked(stacked_cands, omega), omega
        w = np.asarray(fedavg_weights, np.float64)
        new = fns.fedavg_update(global_tree, stacked_cands, w)
        tot = w.sum()
        return new, (w / tot if tot > 0 else w)

    def _aggregate(self, base=None) -> dict:
        """Phase 4 over the candidates ``self.stacked``. With a wire codec
        configured, ``base`` is the tree the clients started the round
        from: candidates arrive as decoded uplink deltas, and the new
        global leaves as a decoded downlink delta."""
        cfg, val, fns = self.cfg, self.val, self.engine.fns
        ecfg, kind, metric = self.ecfg, self.spec.kind, self.cfg.metric
        x_a, x_b = self.data["val"]["x_a"], self.data["val"]["x_b"]
        info = {}

        cand_stacked = self.stacked
        codec_on = self.resid_up is not None
        # the pre-round global tree: the codec's downlink reference
        prev_glob = {k: self.global_models[k] for k in CLIENT_GROUPS}
        if codec_on:
            assert base is not None, "codec rounds must pass the uplink base"
            cand_stacked, self.resid_up = self.engine.codec_uplink(
                cand_stacked, base, self.resid_up)

        blend = self.engine.cfg.strategy.score_based
        for mod, x_val in (("A", x_a), ("B", x_b)):
            present = [cd.has_a if mod == "A" else cd.has_b for cd in self.clients]
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
            else:  # fedavg: data-volume weights
                ns = [cd.n_samples() if p else 0
                      for cd, p in zip(self.clients, present)]
            blended, omega = self._blend_group(glob, cand, scores, gscore, ns)
            info[f"omega_{mod}"] = omega
            self.global_models[f"f_{mod}"] = blended["f"]
            self.global_models[f"g_{mod}"] = blended["g"]

        # multimodal: client g_M heads + the server's g_M^v (Eq. 8)
        present = [cd.has_paired for cd in self.clients] + [True]
        cand = stack_with(cand_stacked["g_M"], self.server_gmv)
        f_a, f_b = self.global_models["f_A"], self.global_models["f_B"]
        scores = gscore = ns = None
        if blend:
            scores = self._candidate_metrics(
                self.engine.multi_scores(f_a, f_b, cand, x_a, x_b), present)
            gscore = eval_multimodal(f_a, f_b, self.global_models["g_M"],
                                     x_a, x_b, val.y, ecfg, kind, metric)
        else:
            # paired counts per client, the server head carrying the VFL
            # overlap size — zero when no rows overlap
            ns = [len(cd.paired_a) if cd.has_paired else 0 for cd in self.clients]
            ns.append(self.data["n_overlap"])
        blended, omega = self._blend_group(self.global_models["g_M"], cand,
                                           scores, gscore, ns)
        info["omega_M"] = omega
        self.global_models["g_M"] = blended
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
        # their optimizer moments; only the weights are replaced.
        glob_groups = {k: self.global_models[k] for k in CLIENT_GROUPS}
        self.stacked = dict(fns.broadcast(glob_groups, cfg.n_clients))
        self.server_gmv = tree_map(torch.clone, gmv_true)
        return info

    # ---- round / fit ----

    def round(self) -> dict:
        """One global training epoch (Algorithm 1 body)."""
        logs = {}
        base = self.stacked  # codec uplink base (pre-round weights)
        for _ in range(self.cfg.local_epochs):
            logs["loss_partial"] = self._unimodal_phase()
            logs["loss_vfl"] = self._vfl_phase()
            logs["loss_paired"] = self._paired_phase()
        logs.update(self._aggregate(base=base))
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
