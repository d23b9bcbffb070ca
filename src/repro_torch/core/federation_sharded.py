"""The BlendFL round as one function over stacked round state (port of
``src/repro/core/federation_sharded.py``).

The reference expresses Algorithm 1 as ONE SPMD program for a TPU mesh:
client k is slice k of the mesh's ``data`` axis, and Eq. 11 is a
weighted reduction over that axis that GSPMD lowers to an all-reduce
(its ``EngineConfig.blend = "reduce"``; a Pallas call has no partition
rule). The port runs on one card, which has no client axis to shard, so
``mesh`` and the shardings reduce to one device (``train_federated.
place_state``) and Eq. 11 goes through ``fns.blend_stacked``: one
launch of the CUDA blend kernel a leaf, as ``Federation`` blends. The
spec has no ``blend`` field. The parity tests hold this blend against
the reference's ``tensordot`` within ``blend_error_bound``.

The four phases are the engine's phase functions (``make_phase_fns``),
the same math ``Federation`` drives; this module adapts them to the
round batch layout of ``repro_torch.data.pipeline.FederatedBatcher``
(padded per-client slabs with 0/1 masks, the PSI alignment as the
``perm_b`` gather) and composes them into one eager function,
``round_fn(state, batch) -> (state', metrics)``, that reads nothing back
to the host: every decision (keep the global where no candidate
improved, skip an empty server step) is a ``torch.where`` on the device.

BlendAvg scores on the device with the (negative) validation LOSS of
every candidate, a monotone surrogate for the paper's AUROC that the
in-host ``Federation`` computes on the host. The blend always launches,
one kernel a leaf of each group (the reference computes it too and
selects the global where no omega is positive).

Partial participation (``ShardedFedSpec.n_sampled`` = K > 0): the host
draws K client ids into the batch's ``sampled`` vector (a
``repro_torch.core.schedule`` policy fed by the ``sched`` telemetry
block this round keeps in its state); the round gathers those rows of
every stacked block (``core.state.sample``), trains at leading axis K,
damps each candidate's omega by its staleness, and scatters the
broadcast back to the participants only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import aggregate as strategies
from repro_torch.core import codec as wire
from repro_torch.core import schedule
from repro_torch.core import state as rstate
from repro_torch.core.encoders import (
    EncoderConfig,
    encoder_apply,
    init_client_models,
)
from repro_torch.core.engine import (
    CLIENT_GROUPS,
    EngineConfig,
    fusion_apply_stacked,
    make_phase_fns,
    masked_mean,
    stack_with,
    task_loss_rows,
)


@dataclasses.dataclass(frozen=True)
class ShardedFedSpec:
    """Static description of the federation workload: the reference's
    fields that a caller of the port sets. Left out: ``blend`` (see the
    module docstring); ``staleness_exp`` and ``ema_beta``, which both
    rounds read from ``blendavg.STALENESS_EXP`` and ``schedule.EMA_BETA``;
    and the cosine schedule and AdamW decay (``schedule``,
    ``total_steps``, ``server_total_steps``, ``weight_decay``), which
    the round takes at ``EngineConfig``'s defaults: a constant lr and no
    decay."""

    n_clients: int = 16
    d_hidden: int = 1024
    n_layers: int = 2
    seq_a: int = 64
    feat_a: int = 128
    seq_b: int = 64
    feat_b: int = 128
    out_dim: int = 25
    kind: str = "multilabel"
    n_partial: int = 512  # per client, per modality
    n_frag: int = 512  # per client (aligned cross-client rows)
    n_paired: int = 512  # per client
    n_val: int = 1024  # server validation set
    n_val_score: int = 0  # BlendAvg scores on this prefix; 0 = all of n_val
    lr: float = 1e-3
    optimizer: str = "sgd"  # sgd | adamw
    n_sampled: int = 0  # K-of-C sampled async rounds; 0 = everyone trains
    policy: str = "uniform"  # repro_torch.core.schedule policy
    codec: str = "none"  # none | int8 | topk | int8_topk
    topk_frac: float = 0.25
    # blendavg | fedavg | scaffold | fedprox | median | trimmed_mean | krum
    strategy: str = "blendavg"
    fedprox_mu: float = 0.0
    server_opt: str = "none"  # none | adam | momentum
    server_lr: float = 1.0
    n_malicious: int = 1
    # the batch carries a per-participant ``attack_coef`` (K,) applied to
    # each candidate's delta before the uplink codec (scenario sign_flip
    # / scale events)
    attacks: bool = False

    def __post_init__(self):
        if not 0 <= self.n_sampled <= self.n_clients:
            raise ValueError(
                f"n_sampled={self.n_sampled} must be in [0, n_clients="
                f"{self.n_clients}]: a K-of-C sampled round cannot gather "
                "more client rows than the federation stacks")
        f = self.n_malicious
        if self.strategy == "krum" and self.k_round < f + 3:
            raise ValueError(
                f"krum needs at least n_malicious + 3 = {f + 3} candidates "
                f"per round to score n - f - 2 neighbors, got K="
                f"{self.k_round}")
        if self.strategy == "trimmed_mean" and self.k_round < 2 * f + 1:
            raise ValueError(
                f"trimmed_mean needs at least 2 * n_malicious + 1 = "
                f"{2 * f + 1} candidates per round, got K={self.k_round}")

    @property
    def ecfg(self) -> EncoderConfig:
        return EncoderConfig(d_hidden=self.d_hidden, n_layers=self.n_layers,
                             enc_type="mlp")

    @property
    def k_round(self) -> int:
        """Clients that train per round (leading axis of the batch)."""
        return self.n_sampled or self.n_clients

    @property
    def engine_cfg(self) -> EngineConfig:
        return EngineConfig(ecfg=self.ecfg, kind=self.kind,
                            optimizer=self.optimizer, lr=self.lr,
                            codec=wire.make_codec(self.codec, self.topk_frac),
                            strategy=strategies.make_strategy(
                                self.strategy, self.fedprox_mu,
                                self.server_opt, self.server_lr,
                                self.n_malicious))


def init_stacked_models(gen: torch.Generator, spec: ShardedFedSpec, device=None):
    """Stacked client models (every leaf with leading axis C, all clients
    from one init), the server head and the global models, drawn from
    ``gen`` on ``device`` (CUDA when None)."""
    from repro_torch.data.synthetic import TaskSpec

    tspec = TaskSpec("sharded", spec.kind, spec.out_dim, spec.seq_a,
                     spec.feat_a, spec.seq_b, spec.feat_b)
    base = init_client_models(gen, tspec, spec.ecfg, device=device)
    stacked = tree_map(
        lambda x: x[None].expand((spec.n_clients,) + tuple(x.shape)).clone(),
        base)
    return stacked, base["g_M"], base


def init_round_state(gen: torch.Generator, spec: ShardedFedSpec,
                     device=None) -> dict:
    """The full round state ``make_blendfl_round`` threads (stacked
    models, global models and server head, stacked optimizer state, the
    async bookkeeping and the ``sched`` telemetry), laid out by
    ``core.state.build_round_state``. The server head's optimizer state
    comes from ``fns.srv_opt``, the optimizer with the server's own
    schedule horizon."""
    device = resolve_device(device)
    stacked, server_gmv, global_models = init_stacked_models(gen, spec, device)
    fns = make_phase_fns(spec.engine_cfg)
    return rstate.build_round_state(
        stacked=stacked, server_gmv=server_gmv, global_models=global_models,
        opt_state=fns.opt.init({k: stacked[k] for k in CLIENT_GROUPS}),
        srv_opt_state=fns.srv_opt.init(server_gmv),
        n_clients=spec.n_clients, codec_on=spec.codec != "none",
        scfg=spec.engine_cfg.strategy)


def make_blendfl_round(spec: ShardedFedSpec):
    """Returns round_fn(state, batch) -> (state', metrics).

    state: see ``init_round_state``. batch (tensors on the state's
    device; leading K = per-round client axis, = C at full participation):
      partial_a (K,Np,Sa,Fa)  partial_ya (K,Np,O)   partial_b / _yb
      frag_a    (K,Nf,Sa,Fa)  frag_y    (K,Nf,O)    frag_b (K,Nf,Sb,Fb)
      perm_b    (K*Nf,) int32 row i of the gathered h_a pairs with row
                perm_b[i] of the gathered h_b (the PSI output)
      paired_a / paired_b (K,Npr,S,F)  paired_y (K,Npr,O)
      partial_ma / partial_mb / paired_m (K,N) 0/1 masks, frag_w (K*Nf,)
                row weights, frag_part_a / _b (K,) bool  [optional]
      sampled   (K,) int32 client ids [n_sampled > 0 only]
      attack_coef (K,) f32 uplink attack coefficient [attacks only]
      val_a (Nv,Sa,Fa) val_b (Nv,Sb,Fb) val_y (Nv,O)

    metrics: 0-dim ``loss_uni``, ``loss_vfl``, ``loss_paired`` and the
    ``omega_A`` / ``omega_B`` (K,) and ``omega_M`` (K+1,) weights, all
    tensors on the device.
    """
    fns = make_phase_fns(spec.engine_cfg)
    ecfg, kind = spec.ecfg, spec.kind
    K = spec.k_round
    scfg = spec.engine_cfg.strategy
    # SCAFFOLD Option-II scaling: optimizer steps each group took this
    # round (encoders step in all three phases; heads in one)
    scaffold_steps = {"f_A": 3.0, "f_B": 3.0, "g_A": 1.0, "g_B": 1.0,
                      "g_M": 1.0}

    def uni_scores(f, g, x, y):
        """-val-loss of each of the stacked unimodal models (higher is
        better), every model on the same validation rows."""
        n = tree_leaves(g)[0].shape[0]
        ones = torch.ones((n, y.shape[0]), dtype=torch.float32, device=y.device)
        return -fns.unimodal_loss(f, g, x[None].expand((n,) + tuple(x.shape)),
                                  y[None].expand((n,) + tuple(y.shape)), ones)[0]

    def multi_scores(g_m, f_a, f_b, val_a, val_b, val_y):
        """-val-loss of each stacked fusion head on the (shared) encoders'
        features."""
        n = tree_leaves(g_m)[0].shape[0]
        h_a = encoder_apply(f_a, val_a, ecfg)
        h_b = encoder_apply(f_b, val_b, ecfg)

        def expand(t):
            return t[None].expand((n,) + tuple(t.shape))

        rows = task_loss_rows(fusion_apply_stacked(g_m, expand(h_a),
                                                   expand(h_b)),
                              expand(val_y), kind)
        return -masked_mean(rows, torch.ones_like(rows))[0]

    def aggregate(models, server_gmv, global_models, batch, staleness):
        """Phase 4 on the device: -val-loss scores, then the (async)
        BlendAvg over the K participating candidates."""
        val_a, val_b, val_y = batch["val_a"], batch["val_b"], batch["val_y"]
        if spec.n_val_score and spec.n_val_score < spec.n_val:
            val_a = val_a[: spec.n_val_score]
            val_b = val_b[: spec.n_val_score]
            val_y = val_y[: spec.n_val_score]

        def unstacked(t):
            return tree_map(lambda x: x[None], t)

        new_global = dict(global_models)
        infos = {}
        for mod, x_val in (("A", val_a), ("B", val_b)):
            f, g = f"f_{mod}", f"g_{mod}"
            scores = uni_scores(models[f], models[g], x_val, val_y)
            gscore = uni_scores(unstacked(global_models[f]),
                                unstacked(global_models[g]), x_val, val_y)[0]
            cand = {"f": models[f], "g": models[g]}
            glob = {"f": global_models[f], "g": global_models[g]}
            blended, omega, _ = fns.blendavg_update(glob, cand, scores, gscore,
                                                    staleness=staleness)
            new_global[f], new_global[g] = blended["f"], blended["g"]
            infos[f"omega_{mod}"] = omega

        # multimodal: K participating heads + the server's g_M^v (Eq. 8);
        # the server head trains every round, so its staleness is 0
        cand = stack_with(models["g_M"], server_gmv)
        stale_m = (None if staleness is None else torch.cat(
            [staleness, torch.zeros(1, dtype=torch.float32,
                                    device=staleness.device)]))
        scores = multi_scores(cand, new_global["f_A"], new_global["f_B"],
                              val_a, val_b, val_y)
        gscore = multi_scores(unstacked(global_models["g_M"]),
                              new_global["f_A"], new_global["f_B"],
                              val_a, val_b, val_y)[0]
        new_global["g_M"], infos["omega_M"], _ = fns.blendavg_update(
            global_models["g_M"], cand, scores, gscore, staleness=stale_m)
        return new_global, infos

    def aggregate_weighted(models, server_gmv, global_models, batch):
        """Phase 4 for the score-free strategies: fedavg / fedprox weight
        each candidate by the rows it trained on this round (read off the
        batch masks), scaffold blends participants uniformly; the robust
        strategies route the same candidates through
        ``fns.robust_update``. The multimodal blend stacks the server's
        g_M^v as candidate K with the live aligned rows as its volume."""
        dev = batch["val_y"].device

        def full(n):
            return torch.full((K,), float(n), dtype=torch.float32, device=dev)

        if "partial_ma" in batch:
            na = torch.sum(batch["partial_ma"], dim=1)
            nb = torch.sum(batch["partial_mb"], dim=1)
        else:
            na = nb = full(spec.n_partial)
        n_pair = (torch.sum(batch["paired_m"], dim=1) if "paired_m" in batch
                  else full(spec.n_paired))
        n_frag = (torch.sum(batch["frag_w"].reshape(K, spec.n_frag), dim=1)
                  if "frag_w" in batch else full(spec.n_frag))
        if scfg.control:
            w_cli = torch.ones((K,), dtype=torch.float32, device=dev)
            w_m = torch.ones((K + 1,), dtype=torch.float32, device=dev)
        else:
            w_cli = na + nb + n_pair + n_frag
            w_m = torch.cat([n_pair, torch.sum(n_frag)[None]])

        new_global = dict(global_models)
        infos = {}
        for mod in ("A", "B"):
            cand = {"f": models[f"f_{mod}"], "g": models[f"g_{mod}"]}
            glob = {"f": global_models[f"f_{mod}"],
                    "g": global_models[f"g_{mod}"]}
            if scfg.robust:
                blended, om = fns.robust_update(glob, cand, w_cli)
            else:
                blended = fns.fedavg_update(glob, cand, w_cli)
                # normalized weights double as the sched telemetry omegas
                om = w_cli / torch.clamp_min(torch.sum(w_cli), 1e-12)
            new_global[f"f_{mod}"] = blended["f"]
            new_global[f"g_{mod}"] = blended["g"]
            infos[f"omega_{mod}"] = om
        cand = stack_with(models["g_M"], server_gmv)
        if scfg.robust:
            new_global["g_M"], infos["omega_M"] = fns.robust_update(
                global_models["g_M"], cand, w_m)
        else:
            new_global["g_M"] = fns.fedavg_update(global_models["g_M"],
                                                  cand, w_m)
            infos["omega_M"] = w_m / torch.clamp_min(torch.sum(w_m), 1e-12)
        return new_global, infos

    def ones_mask(y):
        return torch.ones(y.shape[:2], dtype=torch.float32, device=y.device)

    @torch.no_grad()
    def round_fn(state, batch):
        # one registry-routed gather covers every block: stacked leaves
        # come down to the K sampled rows, global leaves pass through
        idx = batch["sampled"].long() if spec.n_sampled else None
        sub = rstate.sample(state, idx)
        models, opt_state = sub["models"], sub["opt"]
        staleness = (torch.clamp_min(state["round"] - 1 - sub["last_round"], 0)
                     .to(torch.float32) if spec.n_sampled else None)
        server_gmv, srv_state = sub["server_gmv"], sub["srv_opt"]
        codec_on = spec.codec != "none"
        if codec_on:
            # uplink base: the weights each participant starts the round
            # from (its delta crosses the wire), plus its residual rows
            base = models
            resid_up = sub["codec"]["resid_up"]
        # each participant's round-start weights anchor the FedProx pull;
        # SCAFFOLD's c_local rows arrive gathered like opt moments
        anchor = models
        strat = None
        if scfg.control:
            c_local = sub["strat"]["c_local"]
        if scfg.client_active:
            strat = {}
            if scfg.prox:
                strat["anchor"] = anchor
            if scfg.control:
                strat["c_global"] = state["strat"]["c_global"]
                strat["c_local"] = c_local

        # phase 1: local unimodal training (all-ones masks when the batch
        # carries none: every padded row is live)
        p1 = {"xa": batch["partial_a"], "ya": batch["partial_ya"],
              "ma": batch.get("partial_ma", ones_mask(batch["partial_ya"])),
              "xb": batch["partial_b"], "yb": batch["partial_yb"],
              "mb": batch.get("partial_mb", ones_mask(batch["partial_yb"]))}
        models, opt_state, i1 = fns.unimodal_step(models, opt_state, p1, strat)
        # average over the clients that held rows
        wa = (i1["n_a"] > 0).to(torch.float32)
        wb = (i1["n_b"] > 0).to(torch.float32)
        loss_uni = ((torch.sum(i1["loss_a"] * wa) + torch.sum(i1["loss_b"] * wb))
                    / torch.clamp_min(torch.sum(wa) + torch.sum(wb), 1.0))

        # phase 2: split (VFL) training; identity gather on the a side,
        # the PSI permutation on the b side
        dev = batch["frag_y"].device
        p2 = {"xa": batch["frag_a"], "xb": batch["frag_b"],
              "gather_a": torch.arange(K * spec.n_frag, device=dev),
              "gather_b": batch["perm_b"].long(),
              "y": batch["frag_y"].reshape(K * spec.n_frag, -1),
              "w": batch.get("frag_w"),
              "part_a": batch.get("frag_part_a"),
              "part_b": batch.get("frag_part_b")}
        models, server_gmv, opt_state, srv_state, loss_vfl = fns.vfl_step(
            models, server_gmv, opt_state, srv_state, p2, strat)

        # phase 3: local multimodal training on paired rows
        p3 = {"xa": batch["paired_a"], "xb": batch["paired_b"],
              "y": batch["paired_y"],
              "m": batch.get("paired_m", ones_mask(batch["paired_y"]))}
        models, opt_state, i3 = fns.paired_step(models, opt_state, p3, strat)
        wp = (i3["n"] > 0).to(torch.float32)
        loss_paired = (torch.sum(i3["loss"] * wp)
                       / torch.clamp_min(torch.sum(wp), 1.0))

        # SCAFFOLD control-variate update on the true trained weights,
        # before the lossy uplink touches the candidates
        if scfg.control:
            new_cg, new_cl = fns.scaffold_round(
                state["strat"]["c_global"], c_local, anchor, models,
                scaffold_steps, K / spec.n_clients)

        # gradient-space uplink attackers: each participant ships
        # anchor + coef * (trained - anchor); honest rows (coef == 1) pass
        # through exactly
        if spec.attacks:
            coef = batch["attack_coef"].to(torch.float32)

            def forge(t, a):
                c = coef.reshape((K,) + (1,) * (t.dim() - 1))
                forged = (a.float() + c * (t.float() - a.float())).to(t.dtype)
                return torch.where(c == 1.0, t, forged)

            models = tree_map(forge, models, anchor)

        # wire codec, uplink leg: aggregation scores and blends what the
        # server would decode
        if codec_on:
            models, resid_up = fns.codec_uplink(models, base, resid_up)

        # phase 4: aggregation, then the participants-only broadcast
        if scfg.score_based:
            new_global, infos = aggregate(
                models, server_gmv, global_models=state["global_models"],
                batch=batch, staleness=staleness)
        else:
            new_global, infos = aggregate_weighted(
                models, server_gmv, global_models=state["global_models"],
                batch=batch)
        # server-side optimizer on the blended delta, before broadcast
        if scfg.server_opt != "none":
            new_global, srv_moments = fns.server_update(
                state["strat"]["srv"], new_global, state["global_models"])
        # wire codec, downlink leg: clients adopt the decoded blend; the
        # server's own g_M^v re-seeds from the true blend
        srv_gmv_true = new_global["g_M"]
        if codec_on:
            new_global, resid_down = fns.codec_downlink(
                new_global, state["global_models"], state["codec"]["resid_down"])
        bcast = dict(fns.broadcast({k: new_global[k] for k in CLIENT_GROUPS}, K))
        # per-participant sync stamp (K rows; the whole vector at full
        # participation)
        last_round = state["round"].repeat(K if spec.n_sampled
                                           else spec.n_clients)

        # participation telemetry: this round's per-client omega (mean of
        # the three heads' weights, the server head's slot excluded) folds
        # into the EMA at the participants' rows
        cli_omega = (infos["omega_A"] + infos["omega_B"]
                     + infos["omega_M"][:K]) / 3.0
        new_sched = {
            "omega_ema": schedule.ema_update(sub["sched"]["omega_ema"],
                                             cli_omega, schedule.EMA_BETA),
            "part_count": sub["sched"]["part_count"] + 1,
            "last_round": last_round,
        }

        # one registry-routed scatter writes the round back
        updates = {"models": bcast, "server_gmv": srv_gmv_true,
                   "global_models": new_global, "opt": opt_state,
                   "srv_opt": srv_state, "last_round": last_round,
                   "round": state["round"] + 1, "sched": new_sched}
        if codec_on:
            updates["codec"] = {"resid_up": resid_up, "resid_down": resid_down}
        if scfg.stateful:
            new_strat = {}
            if scfg.control:
                new_strat["c_global"] = new_cg
                new_strat["c_local"] = new_cl
            if scfg.server_opt != "none":
                new_strat["srv"] = srv_moments
            updates["strat"] = new_strat
        state = rstate.scatter(state, updates, idx)
        metrics = dict(loss_uni=loss_uni, loss_vfl=loss_vfl,
                       loss_paired=loss_paired, **infos)
        return state, metrics

    return round_fn


def batch_specs(spec: ShardedFedSpec, ragged: bool = False) -> dict:
    """``{key: (shape, numpy dtype)}`` of one round's inputs. Training
    arrays carry the per-round client axis K; a sampled round also takes
    the K ids. ``ragged=True`` adds the keys ``FederatedBatcher`` emits
    for heterogeneous row counts (row masks, aligned-row weights and the
    per-client VFL participation flags)."""
    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
    K = spec.k_round
    specs = {
        "partial_a": ((K, spec.n_partial, spec.seq_a, spec.feat_a), f32),
        "partial_ya": ((K, spec.n_partial, spec.out_dim), f32),
        "partial_b": ((K, spec.n_partial, spec.seq_b, spec.feat_b), f32),
        "partial_yb": ((K, spec.n_partial, spec.out_dim), f32),
        "frag_a": ((K, spec.n_frag, spec.seq_a, spec.feat_a), f32),
        "frag_b": ((K, spec.n_frag, spec.seq_b, spec.feat_b), f32),
        "frag_y": ((K, spec.n_frag, spec.out_dim), f32),
        "perm_b": ((K * spec.n_frag,), i32),
        "paired_a": ((K, spec.n_paired, spec.seq_a, spec.feat_a), f32),
        "paired_b": ((K, spec.n_paired, spec.seq_b, spec.feat_b), f32),
        "paired_y": ((K, spec.n_paired, spec.out_dim), f32),
        "val_a": ((spec.n_val, spec.seq_a, spec.feat_a), f32),
        "val_b": ((spec.n_val, spec.seq_b, spec.feat_b), f32),
        "val_y": ((spec.n_val, spec.out_dim), f32),
    }
    if ragged:
        specs.update({
            "partial_ma": ((K, spec.n_partial), f32),
            "partial_mb": ((K, spec.n_partial), f32),
            "frag_w": ((K * spec.n_frag,), f32),
            "frag_part_a": ((K,), np.dtype(bool)),
            "frag_part_b": ((K,), np.dtype(bool)),
            "paired_m": ((K, spec.n_paired), f32),
        })
    if spec.n_sampled:
        specs["sampled"] = ((K,), i32)
    if spec.attacks:
        specs["attack_coef"] = ((K,), f32)
    return specs
