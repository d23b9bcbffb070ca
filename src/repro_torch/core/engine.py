"""Stacked-client round engine — Algorithm 1's math (port of
``src/repro/core/engine.py``).

Clients live as a leading ``C`` axis on every model/optimizer/batch leaf
("stacked client trees"), so one call steps all clients of a phase at
once:

    phase 1  ``unimodal_step``   masked per-client SGD/AdamW on both
                                 modalities in ONE step
    phase 2  ``vfl_step``        joint split-training step: stacked client
                                 encoders + server head, alignment as a
                                 gather over the flattened (C*N) latent rows
    phase 3  ``paired_step``     masked per-client multimodal SGD/AdamW
    phase 4  ``blend_stacked``   Eq. 11 over the stacked candidates,
             / ``fedavg_update`` through the CUDA blend kernel
             / ``robust_update`` (``repro_torch.kernels.blendavg``; its
             / ``blendavg_update`` plain version on the CPU), with omegas
                                 the caller computed (``Federation``: Eq.
                                 9-10 from host AUROC, ``core.blendavg``)
                                 or Eq. 9-10 on the device from scores
                                 (``omega_from_scores``, the sharded
                                 round's -val-loss); the robust reducers'
                                 order statistics in plain ops

Where the reference maps one client's function over the C axis with
``jax.vmap``, the port writes the batch out: every dense layer of a
stacked model is one batched matmul over C. A phase's loss is the sum of
the per-client losses, and client k's parameters reach only its own
term, so one ``torch.autograd.grad`` over the stacked leaves gives every
client its own gradient.

Static padded batch shapes + per-row masks handle ragged per-client
data: clients that hold no rows for a phase contribute exactly-zero
gradients and are excluded from the parameter AND moment update
(``_where_clients``). The optimizer state holds one shared int32 step.

Shuffles: the reference draws its per-client permutations with
``jax.random`` inside the jitted phase; the port's phase drivers take the
permutation indices as an input (``Federation`` draws them).

Partial participation rides on the same stacked representation: a
K-of-C sampled round gathers K rows of every stacked leaf
(``core.state``), and the phase functions run at leading axis K. The
VFL step takes optional row weights ``w`` for aligned rows whose owner
was not sampled.

Aggregation strategies (``core.aggregate``) enter through
``_strat_grads`` (the FedProx and SCAFFOLD client terms, applied to the
client groups of every phase, never to the server head) and the round
hooks ``scaffold_round`` and ``server_update``.

Nothing here updates a tensor in place: every step returns new trees,
so a caller may hold on to an earlier tree (the codec's round base).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.common.tree import (
    tree_index,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.core import aggregate
from repro_torch.core.blendavg import STALENESS_EXP
from repro_torch.core import codec as wire
from repro_torch.core.encoders import (
    EncoderConfig,
    _check_enc_type,
    encoder_apply,
    fusion_apply,
    task_scores,
)
from repro_torch.core.state import CLIENT_GROUPS, OPT_MOMENT_KEYS
from repro_torch.kernels.blendavg.ops import blend_params
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (
    dense,
    rmsnorm,
    sigmoid_bce,
    softmax_cross_entropy,
)
from repro_torch.models.recurrent import slstm_scan_stacked

UNIMODAL_GROUPS = ("f_A", "g_A", "f_B", "g_B")
VFL_GROUPS = ("f_A", "f_B")
PAIRED_GROUPS = ("f_A", "f_B", "g_M")

_STATE_TREES = OPT_MOMENT_KEYS  # optimizer-state trees mirroring params


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the round engine."""

    ecfg: EncoderConfig
    kind: str  # binary | multilabel | multiclass
    optimizer: str = "sgd"  # sgd | adamw
    lr: float = 1e-3
    momentum: float = 0.0  # sgd only
    weight_decay: float = 0.0  # adamw decoupled decay
    schedule: str = "constant"  # constant | cosine
    total_steps: int = 0  # cosine horizon (optimizer steps, not rounds)
    # The server g_M^v head steps once per VFL phase while clients step
    # once per minibatch, so under a schedule it needs its own (shorter)
    # horizon. 0 = share total_steps (fine for constant lr).
    server_total_steps: int = 0
    # Wire codec applied to the simulated round traffic (uplink candidate
    # deltas, downlink broadcast deltas) around phase-4 aggregation.
    codec: wire.CodecConfig = wire.CodecConfig()
    strategy: aggregate.StrategyConfig = aggregate.StrategyConfig()


def make_optimizer(cfg: EngineConfig) -> optim.Optimizer:
    """Resolve ``EngineConfig`` to a ``repro_torch.optim.Optimizer``."""
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("cosine schedule requires total_steps > 0")
        lr = optim.cosine_decay(cfg.lr, cfg.total_steps)
    elif cfg.schedule == "constant":
        lr = cfg.lr
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.optimizer == "adamw":
        return optim.adamw(lr, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return optim.sgd(lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


# ------------------------------------------------------------ masked losses --

def task_loss_rows(logits, y, kind: str):
    """Per-row task loss (mean over rows == encoders.task_loss)."""
    if kind == "multiclass":
        return softmax_cross_entropy(logits, torch.argmax(y, dim=-1))
    return torch.mean(sigmoid_bce(logits, y), dim=-1)


def masked_mean(rows, mask):
    """(mean over mask-selected rows, number of selected rows), over the
    last axis."""
    n = torch.sum(mask, dim=-1)
    return torch.sum(rows * mask, dim=-1) / torch.clamp_min(n, 1.0), n


# ---------------------------------------------------- stacked forward pass --

def _sdense(p, x):
    """Stacked dense layer: leaves (C, ...), x (C, ..., d_in)."""
    c = x.shape[0]
    y = torch.bmm(x.reshape(c, -1, x.shape[-1]), p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)[:, None, :]
    return y.reshape(*x.shape[:-1], y.shape[-1])


def check_trainable(ecfg: EncoderConfig) -> None:
    """Training runs every encoder type (``mlp``, ``recurrent``,
    ``transformer``): the recurrent and attention encoders' gradients run
    the sLSTM and flash attention backward kernels on the card. Raises
    ``ValueError`` for an unknown type."""
    _check_enc_type(ecfg)


def _stacked_norm(p, h):
    """rmsnorm with a per-client gain: p["g"] (C, d), h (C, ..., d)."""
    g = p["g"].reshape(p["g"].shape[0], *([1] * (h.dim() - 2)), -1)
    return rmsnorm({"g": g}, h)


def encoder_apply_stacked(p, x, ecfg: EncoderConfig):
    """C stacked encoders on their own inputs: x (C, B, S, F) -> (C, B, d).
    One sLSTM or flash attention launch serves all C clients."""
    check_trainable(ecfg)
    h = torch.tanh(_sdense(p["in"], x))
    if ecfg.enc_type == "mlp":
        h = torch.mean(h, dim=2)
        for layer in p["hidden"]:
            h = h + F.gelu(_sdense(layer, h), approximate="tanh")
    elif ecfg.enc_type == "recurrent":
        h = slstm_scan_stacked(p["cell"], h, ecfg.n_heads)[:, :, -1]
    else:  # transformer
        hn = _stacked_norm(p["ln"], h)
        c, b, s, d = hn.shape
        nh = ecfg.n_heads

        def heads(w):  # (C, B, S, d) -> (C*B, nh, S, hd)
            return (_sdense(w, hn).reshape(c * b, s, nh, d // nh)
                    .permute(0, 2, 1, 3))

        att = flash_attention(heads(p["wq"]), heads(p["wk"]), heads(p["wv"]),
                              causal=False)
        h = h + att.permute(0, 2, 1, 3).reshape(c, b, s, d)
        h = h + F.gelu(_sdense(p["ff"], h), approximate="tanh")
        h = torch.mean(h, dim=2)
    return _stacked_norm(p["norm"], h)


def fusion_apply_stacked(p, h_a, h_b):
    h = F.gelu(_sdense(p["mix"], torch.cat([h_a, h_b], dim=-1)),
               approximate="tanh")
    return _sdense(p["out"], h)


def value_and_grad(loss_fn, params):
    """``loss_fn(params) -> (total, aux)``; returns (aux, grads), with the
    gradient of ``total`` for every leaf of ``params``."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        total, aux = loss_fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(total, leaves)
    return tree_map(torch.Tensor.detach, aux), tree_unflatten(params, grads)


# ------------------------------------------------ stacked-state helpers ----

def _where_clients(flag, new, old):
    """Per-client select: flag (C,) bool; every leaf has leading C axis."""
    return tree_map(
        lambda n, o: torch.where(
            flag.reshape(flag.shape + (1,) * (n.dim() - 1)), n, o),
        new, old)


def _state_subset(state, keys):
    """Slice the per-group optimizer-state trees down to ``keys``."""
    sub = {k: v for k, v in state.items() if k not in _STATE_TREES}
    for f in _STATE_TREES:
        if f in state:
            sub[f] = {k: state[f][k] for k in keys}
    return sub


def _state_merge(state, sub):
    """Write a phase's updated state slice back into the full state."""
    out = dict(state)
    for k, v in sub.items():
        out[k] = dict(state[k], **v) if k in _STATE_TREES else v
    return out


def _masked_opt_update(opt, grads, state, params, flags):
    """One optimizer step on stacked params; clients with flag False keep
    their params AND moments untouched (they did not participate). The
    shared ``step`` advances for everyone."""
    updates, new_state = opt.update(grads, state, params)
    new_params = optim.apply_updates(params, updates)
    for grp, flag in flags.items():
        if flag is None:
            continue
        new_params = dict(new_params,
                          **{grp: _where_clients(flag, new_params[grp], params[grp])})
        for f in _STATE_TREES:
            if f in new_state:
                new_state = dict(new_state, **{f: dict(
                    new_state[f],
                    **{grp: _where_clients(flag, new_state[f][grp], state[f][grp])})})
    return new_params, new_state


def stack_with(stacked_tree, extra_tree):
    """Append one unstacked candidate (e.g. the server head) to a stacked
    tree: (C, ...) ++ (...)  ->  (C+1, ...)."""
    return tree_map(lambda s, e: torch.cat([s, e[None]]), stacked_tree,
                    extra_tree)


def _f32(x, device=None) -> torch.Tensor:
    """A weight vector as f32 on ``device`` (a tensor's own when None):
    numpy float64 is rounded to f32 as the reference's
    ``jnp.asarray(x, jnp.float32)`` rounds it."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ------------------------------------------------------------- phase math --

def make_phase_fns(cfg: EngineConfig) -> SimpleNamespace:
    """Build the phase functions closed over ``cfg``; raises
    ``ValueError`` for an unknown encoder type."""
    check_trainable(cfg.ecfg)
    ecfg, kind = cfg.ecfg, cfg.kind
    opt = make_optimizer(cfg)
    srv_opt = (make_optimizer(dataclasses.replace(
        cfg, total_steps=cfg.server_total_steps))
        if cfg.server_total_steps else opt)

    def unimodal_loss(f, g, x, y, mask):
        """Stacked: (C,) masked mean losses and (C,) row counts."""
        h = encoder_apply_stacked(f, x, ecfg)
        return masked_mean(task_loss_rows(_sdense(g, h), y, kind), mask)

    def paired_loss(f_a, f_b, g_m, x_a, x_b, y, mask):
        h_a = encoder_apply_stacked(f_a, x_a, ecfg)
        h_b = encoder_apply_stacked(f_b, x_b, ecfg)
        return masked_mean(
            task_loss_rows(fusion_apply_stacked(g_m, h_a, h_b), y, kind), mask)

    # ---- strategy corrections (core.aggregate) ----

    def _strat_grads(grads, params, strat):
        """Apply the configured client-side strategy terms (FedProx
        proximal pull, SCAFFOLD control-variate correction) to a phase's
        grads; ``strat`` (anchor / c_global / c_local trees) is sliced
        down to the groups being stepped. The default adds no ops."""
        if strat is None or not cfg.strategy.client_active:
            return grads
        sub = {k: {g: v[g] for g in grads} for k, v in strat.items()}
        return aggregate.client_term(cfg.strategy, grads, params, sub)

    # ---- phase 1: local unimodal training (lines 3-8) ----

    def unimodal_step(models, opt_state, batch, strat=None):
        """One optimizer step for ALL clients x BOTH modalities.

        batch: xa (C,B,Sa,Fa) ya (C,B,O) ma (C,B)  + xb/yb/mb. Returns
        (models', opt_state', info) where info carries per-client masked
        losses and row counts for both modalities. ``strat`` is the
        optional per-client strategy block (see ``_strat_grads``).
        """
        params = {k: models[k] for k in UNIMODAL_GROUPS}

        def total(p):
            la, na = unimodal_loss(p["f_A"], p["g_A"], batch["xa"],
                                   batch["ya"], batch["ma"])
            lb, nb = unimodal_loss(p["f_B"], p["g_B"], batch["xb"],
                                   batch["yb"], batch["mb"])
            return torch.sum(la) + torch.sum(lb), (la, na, lb, nb)

        (la, na, lb, nb), grads = value_and_grad(total, params)
        grads = _strat_grads(grads, params, strat)
        flags = {"f_A": na > 0, "g_A": na > 0, "f_B": nb > 0, "g_B": nb > 0}
        sub = _state_subset(opt_state, UNIMODAL_GROUPS)
        new_params, sub = _masked_opt_update(opt, grads, sub, params, flags)
        info = {"loss_a": la, "n_a": na, "loss_b": lb, "n_b": nb}
        return dict(models, **new_params), _state_merge(opt_state, sub), info

    # ---- phase 2: split (VFL) training on fragmented rows (lines 9-23) ----

    def vfl_step(models, server_gmv, opt_state, srv_state, batch, strat=None):
        """One joint split-training step over pre-aligned fragmented rows.

        batch: xa (C,Nfa,Sa,Fa) xb (C,Nfb,Sb,Fb); gather_a/gather_b (n,)
        index the flattened (C*Nf) latent rows into server alignment order
        (the PSI output); y (n,O); part_a/part_b (C,) bool participation.
        An optional row weight ``w`` (n,) masks aligned rows out of the
        split loss: a K-of-C sampled round keeps the alignment's static
        row count and gives weight 0 to rows whose owner was not sampled.
        All grads come from ONE joint backward of the split loss, which is
        definitionally the upload/download exchange.
        """
        params = {k: models[k] for k in VFL_GROUPS}

        def joint(p):
            h_a = encoder_apply_stacked(p["c"]["f_A"], batch["xa"], ecfg)
            h_b = encoder_apply_stacked(p["c"]["f_B"], batch["xb"], ecfg)
            h_a = h_a.reshape(-1, h_a.shape[-1])[batch["gather_a"]]
            h_b = h_b.reshape(-1, h_b.shape[-1])[batch["gather_b"]]
            rows = task_loss_rows(fusion_apply(p["srv"], h_a, h_b),
                                  batch["y"], kind)
            if batch.get("w") is None:
                loss = torch.mean(rows)
            else:
                loss = masked_mean(rows, batch["w"])[0]
            return loss, loss

        loss, g = value_and_grad(joint, {"c": params, "srv": server_gmv})
        # strategy terms correct the CLIENT encoders only: the server's
        # g_M^v head never leaves the server
        grads = _strat_grads(g["c"], params, strat)
        flags = {"f_A": batch.get("part_a"), "f_B": batch.get("part_b")}
        sub = _state_subset(opt_state, VFL_GROUPS)
        new_params, sub = _masked_opt_update(opt, grads, sub, params, flags)
        upd_srv, new_srv = srv_opt.update(g["srv"], srv_state, server_gmv)
        new_gmv = optim.apply_updates(server_gmv, upd_srv)
        if batch.get("w") is not None:
            # with NO live aligned row the grads are exactly zero, but
            # AdamW would still decay the server head's moments, advance
            # its step and weight-decay its params: keep the old head
            live = torch.any(batch["w"] > 0)
            new_gmv = tree_map(lambda n, o: torch.where(live, n, o),
                               new_gmv, server_gmv)
            new_srv = tree_map(lambda n, o: torch.where(live, n, o),
                               new_srv, srv_state)
        return (dict(models, **new_params), new_gmv,
                _state_merge(opt_state, sub), new_srv, loss)

    # ---- phase 3: local multimodal training on paired rows (lines 24-29) ----

    def paired_step(models, opt_state, batch, strat=None):
        """One optimizer step on paired rows for all paired clients.

        batch: xa (C,B,Sa,Fa) xb (C,B,Sb,Fb) y (C,B,O) m (C,B).
        """
        params = {k: models[k] for k in PAIRED_GROUPS}

        def total(p):
            l, n = paired_loss(p["f_A"], p["f_B"], p["g_M"], batch["xa"],
                               batch["xb"], batch["y"], batch["m"])
            return torch.sum(l), (l, n)

        (l, n), grads = value_and_grad(total, params)
        grads = _strat_grads(grads, params, strat)
        flags = {k: n > 0 for k in PAIRED_GROUPS}
        sub = _state_subset(opt_state, PAIRED_GROUPS)
        new_params, sub = _masked_opt_update(opt, grads, sub, params, flags)
        info = {"loss": l, "n": n}
        return dict(models, **new_params), _state_merge(opt_state, sub), info

    # ---- phase 4: BlendAvg aggregation + broadcast (lines 30-32) ----

    def omega_from_scores(scores, global_score, staleness=None):
        """Eq. 9-10 on the device: masked, normalized improvement weights
        and whether any candidate improved (a 0-dim bool tensor, never
        read on the host). ``staleness`` (rounds since a candidate's base
        was current) damps an improvement by (1 + s)^-``STALENESS_EXP``
        before the normalization, as ``blendavg.blendavg_weights`` does
        on the host."""
        delta = scores - global_score
        delta = torch.where(torch.isnan(delta),
                            torch.full_like(delta, float("-inf")), delta)
        w = torch.where(delta > 0, delta, torch.zeros_like(delta))
        if staleness is not None:
            s = torch.clamp_min(staleness.to(torch.float32), 0.0)
            w = w * (1.0 + s) ** (-STALENESS_EXP)
        tot = torch.sum(w)
        omega = torch.where(tot > 0, w / torch.clamp_min(tot, 1e-12),
                            torch.zeros_like(w))
        return omega, tot > 0

    def blend_stacked(stacked_tree, omega):
        """Eq. 11: sum_k omega_k W_k over the leading candidate axis, one
        blend-kernel launch per leaf. omega is cast to f32 first."""
        return blend_params(stacked_tree,
                            _f32(omega, tree_leaves(stacked_tree)[0].device))

    def blendavg_update(global_tree, stacked_cands, scores, global_score,
                        staleness=None):
        """The BlendAvg step on the device: returns (new_global, omega,
        any_improved). The blend always launches (one kernel a leaf), and
        the previous global is kept where no candidate improved, so no
        value is read on the host."""
        omega, any_up = omega_from_scores(scores, global_score, staleness)
        blended = blend_stacked(stacked_cands, omega)
        new = tree_map(lambda b, g: torch.where(any_up, b, g.to(b.dtype)),
                       blended, global_tree)
        return new, omega, any_up

    def fedavg_update(global_tree, stacked_cands, weights):
        """Volume-weighted FedAvg over the stacked candidates. Zero total
        weight keeps the previous global model explicitly."""
        weights = _f32(weights, tree_leaves(stacked_cands)[0].device)
        tot = torch.sum(weights)
        omega = torch.where(tot > 0, weights / torch.clamp_min(tot, 1e-12),
                            torch.zeros_like(weights))
        blended = blend_stacked(stacked_cands, omega)
        return tree_map(lambda b, g: torch.where(tot > 0, b, g.to(b.dtype)),
                        blended, global_tree)

    def robust_update(global_tree, stacked_cands, weights):
        """Byzantine-robust phase-4 reduction (``cfg.strategy`` one of
        ``aggregate.ROBUST``). Returns (new_global, omega), omega the
        effective per-candidate weights (telemetry, not blending):

        - krum: the multi-Krum survivor mask multiplies the volume
          weights, and the product goes through ``fedavg_update`` (the
          blend kernel); at n_malicious = 0 the mask is all ones, so krum
          is fedavg bit for bit;
        - trimmed_mean at trim 0 is ``fedavg_update`` with uniform weights;
        - median / trimmed_mean (trim > 0) are coordinate-wise order
          statistics, no blend; omega reports the uniform 1/n.
        """
        scfg = cfg.strategy
        weights = _f32(weights, tree_leaves(stacked_cands)[0].device)
        n = weights.shape[0]
        if scfg.name == "krum":
            w = weights * aggregate.krum_mask(stacked_cands, scfg.n_malicious)
            new = fedavg_update(global_tree, stacked_cands, w)
            tot = torch.sum(w)
            omega = torch.where(tot > 0, w / torch.clamp_min(tot, 1e-12),
                                torch.zeros_like(w))
            return new, omega
        uniform = torch.full((n,), 1.0 / n, dtype=torch.float32,
                             device=weights.device)
        if scfg.name == "trimmed_mean":
            if scfg.n_malicious == 0:
                return fedavg_update(global_tree, stacked_cands,
                                     uniform), uniform
            new = aggregate.trimmed_mean_tree(stacked_cands, scfg.n_malicious)
        elif scfg.name == "median":
            new = aggregate.coordinate_median_tree(stacked_cands)
        else:
            raise ValueError(f"not a robust strategy: {scfg.name!r}")
        new = tree_map(lambda b, g: b.to(g.dtype), new, global_tree)
        return new, uniform

    def broadcast(global_tree, n_clients: int):
        """LocalUpdate (line 32): every client adopts the blended weights,
        each in storage of its own."""
        return tree_map(
            lambda g: g[None].expand((n_clients,) + tuple(g.shape)).clone(),
            global_tree)

    # ---- wire codec: between the phase outputs and phase-4 aggregation ----

    def codec_uplink(trained, base, resid):
        """Client -> server wire for the stacked candidates: each ships its
        delta vs. ``base`` (+ its error-feedback residual) through the
        lossy codec. Returns (decoded candidates, new residual rows)."""
        return wire.uplink_roundtrip(trained, base, resid, cfg.codec)

    def codec_downlink(new_global, prev_global, resid):
        """Server -> clients broadcast wire: the blend delta vs. the
        global the clients hold. Returns (decoded global, new residual)."""
        return wire.downlink_roundtrip(new_global, prev_global, resid,
                                       cfg.codec)

    # ---- aggregation-strategy round hooks (core.aggregate) ----

    def scaffold_round(c_global, c_local, anchor, trained, steps, frac):
        """SCAFFOLD Option-II control-variate update for the round's
        participants, scaled by the client lr this engine steps with."""
        return aggregate.scaffold_round(cfg.strategy, c_global, c_local,
                                        anchor, trained, steps, cfg.lr, frac)

    def server_update(srv, new_global, prev_global):
        """Server-side FedAdam / momentum on the blended delta."""
        return aggregate.server_update(cfg.strategy, srv, new_global,
                                       prev_global)

    return SimpleNamespace(
        opt=opt, srv_opt=srv_opt, unimodal_loss=unimodal_loss,
        paired_loss=paired_loss,
        unimodal_step=unimodal_step, vfl_step=vfl_step, paired_step=paired_step,
        omega_from_scores=omega_from_scores, blend_stacked=blend_stacked,
        blendavg_update=blendavg_update, fedavg_update=fedavg_update,
        robust_update=robust_update,
        broadcast=broadcast, codec_uplink=codec_uplink,
        codec_downlink=codec_downlink, scaffold_round=scaffold_round,
        server_update=server_update)


# ------------------------------------------------------- in-host driver ----

class RoundEngine:
    """Minibatching driver over the phase functions.

    A phase loops its minibatches in Python; per-batch losses stay on the
    device and a phase returns ONE scalar tensor (one host sync when the
    caller reads it).
    """

    def __init__(self, cfg: EngineConfig, batch_size: int):
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.fns = make_phase_fns(cfg)
        self.opt = self.fns.opt
        self.vfl_phase = self.fns.vfl_step
        self.codec_uplink = self.fns.codec_uplink
        self.codec_downlink = self.fns.codec_downlink
        self.scaffold_round = self.fns.scaffold_round
        self.server_update = self.fns.server_update

    def init_opt_state(self, stacked_models):
        return self.opt.init({k: stacked_models[k] for k in CLIENT_GROUPS})

    def init_server_opt_state(self, server_gmv):
        return self.fns.srv_opt.init(server_gmv)

    # -- phase drivers --

    def unimodal_phase(self, models, opt_state, data, perms, strat=None):
        """data: xa (C,N,Sa,Fa) ya (C,N,O) ma (C,N) + xb/yb/mb, with N a
        multiple of the batch size; perms: (idx_a, idx_b), each (C, N)
        int64 per-client row orders on the data's device. Returns the mean
        of valid per-(client, batch, modality) losses (NaN if none).
        ``strat`` is the optional per-client strategy block, constant
        across the minibatches."""
        B = self.batch_size
        c, n_rows = data["ma"].shape
        idx_a, idx_b = perms
        rows = torch.arange(c, device=idx_a.device)[:, None]
        infos = []
        for t in range(n_rows // B):
            sa = idx_a[:, t * B:(t + 1) * B]
            sb = idx_b[:, t * B:(t + 1) * B]
            batch = {"xa": data["xa"][rows, sa], "ya": data["ya"][rows, sa],
                     "ma": data["ma"][rows, sa],
                     "xb": data["xb"][rows, sb], "yb": data["yb"][rows, sb],
                     "mb": data["mb"][rows, sb]}
            models, opt_state, info = self.fns.unimodal_step(models, opt_state,
                                                             batch, strat)
            infos.append(info)
        st = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
        valid_a = (st["n_a"] > 0).float()
        valid_b = (st["n_b"] > 0).float()
        tot = torch.sum(st["loss_a"] * valid_a) + torch.sum(st["loss_b"] * valid_b)
        cnt = torch.sum(valid_a) + torch.sum(valid_b)
        return models, opt_state, _mean_or_nan(tot, cnt)

    def paired_phase(self, models, opt_state, data, perm, strat=None):
        """data: xa/xb (C,N,S,F) y (C,N,O) m (C,N); perm (C, N) int64."""
        B = self.batch_size
        c, n_rows = data["m"].shape
        rows = torch.arange(c, device=perm.device)[:, None]
        infos = []
        for t in range(n_rows // B):
            sel = perm[:, t * B:(t + 1) * B]
            batch = {k: data[k][rows, sel] for k in ("xa", "xb", "y", "m")}
            models, opt_state, info = self.fns.paired_step(models, opt_state,
                                                           batch, strat)
            infos.append(info)
        loss = torch.stack([i["loss"] for i in infos])
        valid = (torch.stack([i["n"] for i in infos]) > 0).float()
        return models, opt_state, _mean_or_nan(torch.sum(loss * valid),
                                               torch.sum(valid))

    # -- candidate scoring (aggregation): one candidate at a time, so a
    #    full-width validation pass holds one candidate's activations --

    @torch.no_grad()
    def uni_scores(self, f_stack, g_stack, x):
        """(C,...) stacked unimodal models -> (C, Nv, O) val scores."""
        ecfg, kind = self.cfg.ecfg, self.cfg.kind
        c = tree_leaves(g_stack)[0].shape[0]
        return torch.stack([
            task_scores(dense(tree_index(g_stack, k),
                              encoder_apply(tree_index(f_stack, k), x, ecfg)),
                        kind)
            for k in range(c)])

    @torch.no_grad()
    def multi_scores(self, f_a, f_b, gm_stack, x_a, x_b):
        """Stacked fusion heads on the (shared) global encoders."""
        ecfg, kind = self.cfg.ecfg, self.cfg.kind
        h_a = encoder_apply(f_a, x_a, ecfg)
        h_b = encoder_apply(f_b, x_b, ecfg)
        c = tree_leaves(gm_stack)[0].shape[0]
        return torch.stack([
            task_scores(fusion_apply(tree_index(gm_stack, k), h_a, h_b), kind)
            for k in range(c)])


def _mean_or_nan(tot, cnt):
    return torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0),
                       torch.full_like(tot, float("nan")))
