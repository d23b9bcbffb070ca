"""The paper's seven FL baselines + centralized learning (§IV-C; port of
``src/repro/core/baselines.py``).

Every baseline consumes the same partitioned clients and returns the same
metric dict as ``federation.evaluate_global``, so Tables I-III are
apples-to-apples. HFL baselines train local models on ALL locally held
data (fragmented rows are only usable unimodally without a VFL exchange);
VFL baselines train on the cross-client aligned sample set.

Implementation notes (documented deviations, all favorable to baselines):
- FedMA: greedy neuron matching on hidden-layer weights (the full
  Hungarian/BBP-MAP of the paper is replaced by greedy best-match, which
  is the standard light implementation); non-matchable leaves are plain
  averaged.
- One-Shot VFL: the local semi-supervised stage is supervised here (our
  synthetic clients all hold labels), followed by the single feature
  upload and server-side head training on frozen latents.
- HFCL: clients are split half/half into FL-capable and data-sharing; the
  server trains a surrogate model on the pooled shared data and joins the
  FedAvg average.

Port notes. Every ``run_*`` takes ``(gen, spec, ecfg, clients, val, test,
cfg, ..., history_test=None, *, base=None, device=None)``: ``gen`` (a
``torch.Generator``) draws the initial models unless ``base`` (a tree of
numpy arrays or tensors keyed like the models, as ``Federation.init``
takes it) gives them; ``device`` is CUDA when None and raises without it.
The steps are eager autograd with out-of-place updates; the shuffles are
the reference's numpy ``default_rng(cfg.seed)`` draws, taken in the same
order. Aggregation blends through ``core.blendavg.blend_trees``, one
blend-kernel launch a model tree on the card. Every encoder type trains
(the ``recurrent`` and ``transformer`` ones through the sLSTM and flash
attention backward kernels on the card), but FedMA's matching takes the
``mlp`` encoders alone, as the reference asserts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.convert import params_to_device
from repro_torch.core import vfl
from repro_torch.core.blendavg import blend_trees
from repro_torch.core.encoders import (
    encoder_apply,
    fusion_apply,
    init_client_models,
    task_loss,
)
from repro_torch.core.engine import check_trainable, value_and_grad
from repro_torch.core.federation import FedConfig, eval_multimodal, eval_unimodal
from repro_torch.core.partitioner import ClientData, ModalView
from repro_torch.data.synthetic import SyntheticMultimodal
from repro_torch.models.common import dense


# Baseline-local per-client SGD steps. The BlendFL federation itself runs
# on the stacked-client engine (repro_torch.core.engine); the baselines
# keep the simple one-client-at-a-time loop — their published forms are
# sequential and per-client, and benchmark parity is with the paper, not
# the engine.

def _sgd(params, grads, lr):
    return tree_map(lambda p, gr: p - lr * gr, params, grads)


def _twice(loss):
    """A loss as ``value_and_grad`` takes it: (total, aux)."""
    return loss, loss


def _unimodal_sgd_step(f, g, x, y, *, ecfg, kind, lr):
    def loss_fn(p):
        h = encoder_apply(p[0], x, ecfg)
        return _twice(task_loss(dense(p[1], h), y, kind))

    loss, (gf, gg) = value_and_grad(loss_fn, (f, g))
    return _sgd(f, gf, lr), _sgd(g, gg, lr), loss


def _paired_sgd_step(f_a, f_b, g_m, x_a, x_b, y, *, ecfg, kind, lr):
    def loss_fn(p):
        h_a = encoder_apply(p[0], x_a, ecfg)
        h_b = encoder_apply(p[1], x_b, ecfg)
        return _twice(task_loss(fusion_apply(p[2], h_a, h_b), y, kind))

    loss, (gfa, gfb, ggm) = value_and_grad(loss_fn, (f_a, f_b, g_m))
    return _sgd(f_a, gfa, lr), _sgd(f_b, gfb, lr), _sgd(g_m, ggm, lr), loss


def _ref_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves`` sorts dict
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ref_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _ref_leaves(v)]
    return [tree]


def _unimodal_prox_step(f, g, x, y, f0, g0, *, ecfg, kind, lr, mu):
    """FedProx local step: + mu/2 ||w - w_global||^2."""

    def loss_fn(p):
        h = encoder_apply(p[0], x, ecfg)
        base = task_loss(dense(p[1], h), y, kind)
        sq = lambda t, t0: sum(torch.sum(torch.square(a - b)) for a, b in
                               zip(_ref_leaves(t), _ref_leaves(t0)))
        return _twice(base + 0.5 * mu * (sq(p[0], f0) + sq(p[1], g0)))

    loss, (gf, gg) = value_and_grad(loss_fn, (f, g))
    return _sgd(f, gf, lr), _sgd(g, gg, lr), loss


def _evaluate(models: dict, test: SyntheticMultimodal, ecfg, kind) -> dict:
    out = {}
    for metric in ("auroc", "auprc"):
        out[f"multimodal_{metric}"] = eval_multimodal(
            models["f_A"], models["f_B"], models["g_M"],
            test.x_a, test.x_b, test.y, ecfg, kind, metric)
        out[f"uni_a_{metric}"] = eval_unimodal(
            models["f_A"], models["g_A"], test.x_a, test.y, ecfg, kind, metric)
        out[f"uni_b_{metric}"] = eval_unimodal(
            models["f_B"], models["g_B"], test.x_b, test.y, ecfg, kind, metric)
    return out


# ---------------------------------------------------------------- helpers --

def _init_models(gen, spec, ecfg, base, device) -> dict:
    """The initial models on ``device``: ``base`` if given, else drawn
    from ``gen``."""
    check_trainable(ecfg)
    device = resolve_device(device)
    if base is None:
        return init_client_models(gen, spec, ecfg, device=device)
    return params_to_device(base, device)


def _clone(models: dict) -> dict:
    return tree_map(torch.clone, models)


def _device(models: dict) -> torch.device:
    return tree_leaves(models)[0].device


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _batches(view: ModalView, bs: int, rng, device):
    idx = rng.permutation(len(view))
    for i in range(0, len(idx), bs):
        sel = idx[i : i + bs]
        yield _on(view.x[sel], device), _on(view.y[sel], device)


def _paired_batches(cd: ClientData, bs: int, rng, device):
    idx = rng.permutation(len(cd.paired_a))
    for i in range(0, len(idx), bs):
        sel = idx[i : i + bs]
        yield (_on(cd.paired_a.x[sel], device), _on(cd.paired_b.x[sel], device),
               _on(cd.paired_a.y[sel], device))


def _local_train(models: dict, cd: ClientData, ecfg, kind, lr, bs, epochs, rng,
                 prox_mu: float = 0.0, global_ref: dict | None = None) -> int:
    """Local training on all local data (HFL client). Returns #local steps."""
    dev = _device(models)
    steps = 0
    for _ in range(epochs):
        for mod, view in (("A", cd.all_a()), ("B", cd.all_b())):
            if len(view) == 0:
                continue
            f, g = models[f"f_{mod}"], models[f"g_{mod}"]
            for x, y in _batches(view, bs, rng, dev):
                if prox_mu > 0:
                    f, g, _ = _unimodal_prox_step(
                        f, g, x, y, global_ref[f"f_{mod}"], global_ref[f"g_{mod}"],
                        ecfg=ecfg, kind=kind, lr=lr, mu=prox_mu)
                else:
                    f, g, _ = _unimodal_sgd_step(f, g, x, y, ecfg=ecfg, kind=kind,
                                                 lr=lr)
                steps += 1
            models[f"f_{mod}"], models[f"g_{mod}"] = f, g
        if cd.has_paired:
            f_a, f_b, g_m = models["f_A"], models["f_B"], models["g_M"]
            for x_a, x_b, y in _paired_batches(cd, bs, rng, dev):
                f_a, f_b, g_m, _ = _paired_sgd_step(f_a, f_b, g_m, x_a, x_b, y,
                                                    ecfg=ecfg, kind=kind, lr=lr)
                steps += 1
            models["f_A"], models["f_B"], models["g_M"] = f_a, f_b, g_m
    return steps


# --------------------------------------------------------------- HFL core --

def _hfl_train(gen, spec, ecfg, clients, test, cfg: FedConfig, *,
               aggregate, prox_mu: float = 0.0, history_test=None,
               base=None, device=None):
    """Shared HFL loop: local train -> aggregate(weights, n_samples, taus)."""
    global_m = _init_models(gen, spec, ecfg, base, device)
    rng = np.random.default_rng(cfg.seed)
    kind = spec.kind
    history = []
    for r in range(cfg.rounds):
        local = [_clone(global_m) for _ in clients]
        taus = []
        for k, cd in enumerate(clients):
            taus.append(_local_train(local[k], cd, ecfg, kind, cfg.lr,
                                     cfg.batch_size, cfg.local_epochs, rng,
                                     prox_mu=prox_mu, global_ref=global_m))
        global_m = aggregate(global_m, local, clients, taus)
        if history_test is not None:
            history.append(dict(_evaluate(global_m, history_test, ecfg, kind), round=r))
    return global_m, history


def _groups(clients) -> dict:
    """Model groups and the clients that hold each group's modality."""
    return {
        "A": (["f_A", "g_A"], [k for k, c in enumerate(clients) if c.has_a]),
        "B": (["f_B", "g_B"], [k for k, c in enumerate(clients) if c.has_b]),
        "M": (["g_M"], [k for k, c in enumerate(clients) if c.has_paired]),
    }


def _data_weights(clients, members) -> np.ndarray:
    ns = np.asarray([clients[k].n_samples() for k in members], np.float64)
    return ns / ns.sum()


def _group_avg(global_m, local, clients, taus=None):
    """FedAvg's aggregate: average each model group over the clients that
    hold that modality, weighted by their data volume (``taus``, the
    local step counts, are FedNova's)."""
    del taus
    out = dict(global_m)
    for _, (keys, members) in _groups(clients).items():
        if not members:
            continue
        w = _data_weights(clients, members)
        for gk in keys:
            out[gk] = blend_trees([local[k][gk] for k in members], w)
    return out


def run_fedavg(gen, spec, ecfg, clients, val, test, cfg: FedConfig, history_test=None,
               *, base=None, device=None):
    del val
    gm, hist = _hfl_train(gen, spec, ecfg, clients, test, cfg,
                          aggregate=_group_avg, history_test=history_test,
                          base=base, device=device)
    return _evaluate(gm, test, ecfg, spec.kind), hist


def run_fedprox(gen, spec, ecfg, clients, val, test, cfg: FedConfig, mu: float = 0.01,
                history_test=None, *, base=None, device=None):
    del val
    gm, hist = _hfl_train(gen, spec, ecfg, clients, test, cfg,
                          aggregate=_group_avg, prox_mu=mu,
                          history_test=history_test, base=base, device=device)
    return _evaluate(gm, test, ecfg, spec.kind), hist


def run_fednova(gen, spec, ecfg, clients, val, test, cfg: FedConfig, history_test=None,
                *, base=None, device=None):
    """Normalized averaging: updates d_k = (w_g - w_k)/tau_k, combined with
    data weights p_k and effective step count tau_eff = sum p_k tau_k."""
    del val

    def aggregate(global_m, local, clients_, taus):
        out = dict(global_m)
        for _, (keys, members) in _groups(clients_).items():
            if not members:
                continue
            p = _data_weights(clients_, members)
            tk = np.asarray([max(taus[k], 1) for k in members], np.float64)
            tau_eff = float(np.sum(p * tk))
            for gk in keys:
                # w <- w_g - tau_eff * sum_k p_k (w_g - w_k)/tau_k; the
                # divisor is a tensor: CUDA multiplies by the reciprocal
                # of a Python number (ROADMAP.md fault (b))
                deltas = [tree_map(lambda g, l: (g - l) / torch.tensor(
                              tk[i], dtype=g.dtype, device=g.device),
                                   global_m[gk], local[k][gk])
                          for i, k in enumerate(members)]
                comb = blend_trees(deltas, p)
                out[gk] = tree_map(lambda g, d: g - tau_eff * d, global_m[gk], comb)
        return out

    gm, hist = _hfl_train(gen, spec, ecfg, clients, test, cfg, aggregate=aggregate,
                          history_test=history_test, base=base, device=device)
    return _evaluate(gm, test, ecfg, spec.kind), hist


def _greedy_match(ref: np.ndarray, cand: np.ndarray, device=None) -> torch.Tensor:
    """Greedy permutation aligning cand's rows to ref's rows by cosine sim.

    ``sim`` is the reference's numpy expression on the host copies; the n
    greedy picks run on ``device`` (CUDA when None), each an argmax over
    a masked copy of ``sim`` whose picked row and column are then set to
    -inf. ``torch.argmax`` returns the first maximal index of the
    flattened array, as ``np.argmax`` does, so ties pick alike. Returns
    the permutation as an int64 tensor on ``device``."""
    device = resolve_device(device)
    n = ref.shape[0]
    sim = (ref / (np.linalg.norm(ref, axis=1, keepdims=True) + 1e-9)) @ (
        cand / (np.linalg.norm(cand, axis=1, keepdims=True) + 1e-9)).T
    s = torch.from_numpy(np.ascontiguousarray(sim)).to(device)
    perm = torch.empty(n, dtype=torch.int64, device=device)
    for _ in range(n):
        # one-element index tensors: no host read inside the loop
        flat = torch.argmax(s).reshape(1)
        i, j = flat // n, flat % n
        perm.index_copy_(0, i, j)
        s.index_fill_(0, i, float("-inf"))  # s is this function's own copy
        s.index_fill_(1, j, float("-inf"))
    return perm


def _match_encoder(ref_ws, f):
    """Permute f's hidden units (rows of out-dim) to align with the
    reference member's; ``ref_ws`` holds the host copies of its hidden
    weights."""
    hidden = []
    for ref_w, layer in zip(ref_ws, f["hidden"]):
        perm = _greedy_match(ref_w.T, layer["w"].cpu().numpy().T,
                             device=layer["w"].device)
        hidden.append({"w": layer["w"][:, perm], "b": layer["b"][perm]})
        # note: residual MLP keeps the feature basis, so downstream
        # layers need no inverse permutation (h + gelu(Wh) form)
    return dict(f, hidden=hidden)


def run_fedma(gen, spec, ecfg, clients, val, test, cfg: FedConfig, history_test=None,
              *, base=None, device=None):
    """Matched averaging (greedy variant) on the encoder hidden layers.
    Matching is implemented for the ``mlp`` encoders alone."""
    del val
    if ecfg.enc_type != "mlp":
        raise NotImplementedError(
            f"FedMA matches the hidden units of the mlp encoders only, as the "
            f"reference asserts (src/repro/core/baselines.py:289); got "
            f"enc_type={ecfg.enc_type!r}")

    def aggregate(global_m, local, clients_, taus):
        out = dict(global_m)
        groups = {
            "A": ("f_A", "g_A", [k for k, c in enumerate(clients_) if c.has_a]),
            "B": ("f_B", "g_B", [k for k, c in enumerate(clients_) if c.has_b]),
        }
        for _, (fk, gk, members) in groups.items():
            if not members:
                continue
            w = _data_weights(clients_, members)
            ref = local[members[0]][fk]
            ref_ws = [layer["w"].cpu().numpy() for layer in ref["hidden"]]
            matched = [ref] + [_match_encoder(ref_ws, local[k][fk]) for k in members[1:]]
            out[fk] = blend_trees(matched, w)
            out[gk] = blend_trees([local[k][gk] for k in members], w)
        mm = [k for k, c in enumerate(clients_) if c.has_paired]
        if mm:
            out["g_M"] = blend_trees([local[k]["g_M"] for k in mm],
                                     _data_weights(clients_, mm))
        return out

    gm, hist = _hfl_train(gen, spec, ecfg, clients, test, cfg, aggregate=aggregate,
                          history_test=history_test, base=base, device=device)
    return _evaluate(gm, test, ecfg, spec.kind), hist


def run_hfcl(gen, spec, ecfg, clients, val, test, cfg: FedConfig, history_test=None,
             *, base=None, device=None):
    """Hybrid federated/centralized: the low-compute half of the clients
    ship raw data to the server; the server trains a surrogate client."""
    del val
    n = len(clients)
    fl_ids = list(range(0, n, 2))  # odd-indexed clients share data
    shared = [clients[k] for k in range(n) if k not in fl_ids]

    def pool(views, seq, feat):
        views = [v for v in views if len(v)]
        return (ModalView.concat(views) if views
                else ModalView.empty(seq, feat, spec.out_dim))

    a, b = (spec.seq_a, spec.feat_a), (spec.seq_b, spec.feat_b)
    pooled = ClientData(
        partial_a=pool([c.partial_a for c in shared], *a),
        partial_b=pool([c.partial_b for c in shared], *b),
        frag_a=pool([c.frag_a for c in shared], *a),
        frag_b=pool([c.frag_b for c in shared], *b),
        paired_a=pool([c.paired_a for c in shared], *a),
        paired_b=pool([c.paired_b for c in shared], *b),
    )
    eff_clients = [clients[k] for k in fl_ids] + [pooled]
    gm, hist = _hfl_train(gen, spec, ecfg, eff_clients, test, cfg,
                          aggregate=_group_avg, history_test=history_test,
                          base=base, device=device)
    return _evaluate(gm, test, ecfg, spec.kind), hist


# --------------------------------------------------------------- VFL side --

def _aligned_vertical_rows(clients):
    """Samples usable by conventional (fixed-party) VFL: the CROSS-CLIENT
    fragmented overlap. A client's locally-paired rows are NOT vertically
    trainable under the conventional protocol — the party structure is
    fixed per modality, and a client cannot act as both parties for a
    subset of rows (exactly the 'restrictive assumptions' the paper
    criticizes; BlendFL uses those rows in its paired phase instead).
    The reference's ``include_paired=True`` variant, which no baseline
    runs, is not ported."""
    batches = vfl.build_vfl_batches(clients, 10**9, np.random.default_rng(0))
    if not batches:
        return None
    return batches[0].x_a, batches[0].x_b, batches[0].y


def run_splitnn(gen, spec, ecfg, clients, val, test, cfg: FedConfig, history_test=None,
                *, base=None, device=None):
    """Pure VFL: split training of shared encoders + a server fusion head
    on the vertically aligned sample set. Unimodal columns come from
    server-side unimodal heads on the same latents (the conventional-VFL
    serving path; no decentralized inference exists here)."""
    del val
    models = _init_models(gen, spec, ecfg, base, device)
    rows = _aligned_vertical_rows(clients)
    kind = spec.kind
    dev = _device(models)
    rng = np.random.default_rng(cfg.seed)
    history = []
    if rows is None:
        return _evaluate(models, test, ecfg, kind), history
    xa, xb, y = rows
    for r in range(cfg.rounds * cfg.local_epochs):
        idx = rng.permutation(len(y))
        for i in range(0, len(idx), cfg.batch_size):
            sel = idx[i : i + cfg.batch_size]
            x_a, x_b, y_b = _on(xa[sel], dev), _on(xb[sel], dev), _on(y[sel], dev)
            with torch.no_grad():
                h_a = vfl.client_forward(models["f_A"], x_a, ecfg)
                h_b = vfl.client_forward(models["f_B"], x_b, ecfg)
            _, g_srv, g_ha, g_hb = vfl.server_forward_backward(
                models["g_M"], h_a, h_b, y_b, kind)
            models["g_M"] = _sgd(models["g_M"], g_srv, cfg.lr)
            models["f_A"] = _sgd(models["f_A"], vfl.client_backward(
                models["f_A"], x_a, g_ha, ecfg), cfg.lr)
            models["f_B"] = _sgd(models["f_B"], vfl.client_backward(
                models["f_B"], x_b, g_hb, ecfg), cfg.lr)
            # server-side unimodal heads on the (detached) latents
            for mod, h in (("A", h_a), ("B", h_b)):
                _, gg = value_and_grad(
                    lambda g, h=h: _twice(task_loss(dense(g, h), y_b, kind)),
                    models[f"g_{mod}"])
                models[f"g_{mod}"] = _sgd(models[f"g_{mod}"], gg, cfg.lr)
        if history_test is not None:
            history.append(dict(_evaluate(models, history_test, ecfg, kind), round=r))
    return _evaluate(models, test, ecfg, kind), history


def run_oneshot_vfl(gen, spec, ecfg, clients, val, test, cfg: FedConfig,
                    history_test=None, *, base=None, device=None):
    """One-Shot VFL: local (supervised) encoder training, ONE feature
    upload, then server-side fusion-head training on frozen latents."""
    del val
    kind = spec.kind
    rng = np.random.default_rng(cfg.seed)
    models = _init_models(gen, spec, ecfg, base, device)
    dev = _device(models)
    locals_ = [_clone(models) for _ in clients]
    # stage 1: purely local training
    for k, cd in enumerate(clients):
        _local_train(locals_[k], cd, ecfg, kind, cfg.lr, cfg.batch_size,
                     cfg.rounds * cfg.local_epochs, rng)
    # one-shot aggregation of unimodal models (single communication)
    for mod in "AB":
        members = [k for k, c in enumerate(clients)
                   if (c.has_a if mod == "A" else c.has_b)]
        if members:
            w = _data_weights(clients, members)
            models[f"f_{mod}"] = blend_trees([locals_[k][f"f_{mod}"] for k in members], w)
            models[f"g_{mod}"] = blend_trees([locals_[k][f"g_{mod}"] for k in members], w)
    # stage 2: single latent upload, server trains the fusion head
    rows = _aligned_vertical_rows(clients)
    history = []
    if rows is not None:
        xa, xb, y = rows
        with torch.no_grad():
            h_a = vfl.client_forward(models["f_A"], _on(xa, dev), ecfg)
            h_b = vfl.client_forward(models["f_B"], _on(xb, dev), ecfg)
        for r in range(cfg.rounds):
            idx = rng.permutation(len(y))
            for i in range(0, len(idx), cfg.batch_size):
                sel = idx[i : i + cfg.batch_size]
                rows_d = torch.as_tensor(sel, device=dev)
                y_b = _on(y[sel], dev)
                _, gg = value_and_grad(
                    lambda gm: _twice(task_loss(
                        fusion_apply(gm, h_a[rows_d], h_b[rows_d]), y_b, kind)),
                    models["g_M"])
                models["g_M"] = _sgd(models["g_M"], gg, cfg.lr)
            if history_test is not None:
                history.append(dict(_evaluate(models, history_test, ecfg, kind), round=r))
    return _evaluate(models, test, ecfg, kind), history


# ------------------------------------------------------------- centralized --

def run_centralized(gen, spec, ecfg, clients, val, test, cfg: FedConfig,
                    history_test=None, *, base=None, device=None):
    """Upper bound: pool ALL raw data centrally. Fragmented samples become
    paired (the center can join them), so the multimodal model trains on
    paired + fragmented-joined rows; unimodal models train on everything."""
    del val
    kind = spec.kind
    rng = np.random.default_rng(cfg.seed)
    models = _init_models(gen, spec, ecfg, base, device)
    dev = _device(models)
    all_a = ModalView.concat([c.all_a() for c in clients])
    all_b = ModalView.concat([c.all_b() for c in clients])
    rows = _aligned_vertical_rows(clients)
    history = []
    for r in range(cfg.rounds * cfg.local_epochs):
        for mod, view in (("A", all_a), ("B", all_b)):
            f, g = models[f"f_{mod}"], models[f"g_{mod}"]
            for x, y in _batches(view, cfg.batch_size, rng, dev):
                f, g, _ = _unimodal_sgd_step(f, g, x, y, ecfg=ecfg, kind=kind,
                                             lr=cfg.lr)
            models[f"f_{mod}"], models[f"g_{mod}"] = f, g
        if rows is not None:
            xa, xb, y = rows
            idx = rng.permutation(len(y))
            f_a, f_b, g_m = models["f_A"], models["f_B"], models["g_M"]
            for i in range(0, len(idx), cfg.batch_size):
                sel = idx[i : i + cfg.batch_size]
                f_a, f_b, g_m, _ = _paired_sgd_step(
                    f_a, f_b, g_m, _on(xa[sel], dev), _on(xb[sel], dev),
                    _on(y[sel], dev), ecfg=ecfg, kind=kind, lr=cfg.lr)
            models["f_A"], models["f_B"], models["g_M"] = f_a, f_b, g_m
        if history_test is not None:
            history.append(dict(_evaluate(models, history_test, ecfg, kind), round=r))
    return _evaluate(models, test, ecfg, kind), history


BASELINES = {
    "centralized": run_centralized,
    "fedavg": run_fedavg,
    "fedma": run_fedma,
    "fedprox": run_fedprox,
    "fednova": run_fednova,
    "oneshot_vfl": run_oneshot_vfl,
    "hfcl": run_hfcl,
    "splitnn": run_splitnn,
}
