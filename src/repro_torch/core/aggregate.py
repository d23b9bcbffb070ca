"""Aggregation strategies (port of ``src/repro/core/aggregate.py``).

One strategy interface over the stacked client trees the round engine
speaks:

    init_state      strategy state trees, threaded through the round
                    ({} for the stateless blendavg / fedavg / fedprox and
                    the robust reducers)
    client_term     additive per-step gradient correction inside the
                    engine's phase functions: the FedProx proximal pull
                    mu * (w - anchor) and/or the SCAFFOLD control-variate
                    correction c_global - c_local
    scaffold_round  post-round control-variate update (SCAFFOLD Option
                    II): participants' c_local rows move by
                    (anchor - trained) / (steps * lr), c_global absorbs
                    the participation-weighted mean shift
    server_update   server-side optimizer (FedAdam / momentum) applied
                    to the blended delta before broadcast

Aggregation weights per strategy (the federation's ``_blend_group``
consumes them):

    blendavg   Eq. 9-10 validation-improvement omegas (score-based)
    fedavg     data-volume weights
    fedprox    data-volume weights (the prox term is client-side)
    scaffold   uniform over participants

Byzantine-robust reducers, stateless strategy names that change only
how candidates reduce to the new global:

    median        coordinate-wise median (the mean of the two middle
                  values at even n, as ``jnp.median``)
    trimmed_mean  coordinate-wise mean after dropping the n_malicious
                  largest and smallest values (n >= 2 * n_malicious + 1)
    krum          multi-Krum: the m = n - f candidates with the lowest
                  summed squared distances to their n - f - 2 nearest
                  peers, averaged through the volume-weighted fedavg
                  path; at n_malicious = 0 every candidate survives, so
                  krum is fedavg bit for bit

State layout (only the keys a strategy needs exist):

    c_global   per-group trees, unstacked (the server's control variate)
    c_local    per-group trees with a leading C axis, gathered and
               scattered by sampled ids like opt moments
    srv        server-optimizer moments: {m, t} (momentum) or {m, v, t}
               (adam), trees matching the global model groups

Everything here is plain tensor arithmetic (the reference computes it in
plain jnp, outside any Pallas kernel); nothing updates a tensor in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import state as round_state

ROBUST = ("median", "trimmed_mean", "krum")
STRATEGIES = ("blendavg", "fedavg", "scaffold", "fedprox") + ROBUST
SERVER_OPTS = ("none", "adam", "momentum")

# The server optimizers' moment decays and FedAdam's tau (Reddi et al.
# 2021), the reference's defaults.
SERVER_BETA1 = 0.9
SERVER_BETA2 = 0.99
SERVER_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Static aggregation-strategy configuration."""

    name: str = "blendavg"  # one of STRATEGIES
    # FedProx proximal coefficient: adds mu/2 * ||w - anchor||^2 to every
    # client objective (as the exact gradient term mu * (w - anchor)).
    fedprox_mu: float = 0.0
    # Server-side optimizer applied to the blended delta before
    # broadcast; composes with any strategy name.
    server_opt: str = "none"  # one of SERVER_OPTS
    server_lr: float = 1.0
    # Assumed malicious-client budget f of the robust reducers: the trim
    # count a side for trimmed_mean, the f of multi-Krum's m = n - f
    # survivors and n - f - 2 neighbours. Ignored by the other strategies
    # and by median.
    n_malicious: int = 1

    def __post_init__(self):
        if self.name not in STRATEGIES:
            raise ValueError(f"strategy {self.name!r} not in {STRATEGIES}")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(
                f"server_opt {self.server_opt!r} not in {SERVER_OPTS}")
        if self.fedprox_mu < 0:
            raise ValueError(f"fedprox_mu must be >= 0, got {self.fedprox_mu}")
        if self.fedprox_mu and self.name not in ("fedprox",):
            raise ValueError("fedprox_mu > 0 requires strategy 'fedprox' "
                             f"(got {self.name!r})")
        if not isinstance(self.n_malicious, int) or self.n_malicious < 0:
            raise ValueError(
                f"n_malicious must be an int >= 0, got {self.n_malicious!r}")

    @property
    def prox(self) -> bool:
        """Client loss carries the proximal pull."""
        return self.fedprox_mu > 0

    @property
    def control(self) -> bool:
        """Client steps carry SCAFFOLD control-variate corrections."""
        return self.name == "scaffold"

    @property
    def client_active(self) -> bool:
        """Phase functions need the per-client ``strat`` block (anchor
        and/or control variates)."""
        return self.prox or self.control

    @property
    def stateful(self) -> bool:
        """The strategy threads state through the rounds."""
        return self.control or self.server_opt != "none"

    @property
    def score_based(self) -> bool:
        """Aggregation weights come from validation scores (Eq. 9-10)."""
        return self.name == "blendavg"

    @property
    def robust(self) -> bool:
        """Candidates reduce through a Byzantine-robust reducer instead
        of a weighted average."""
        return self.name in ROBUST


def make_strategy(name: str = "blendavg", fedprox_mu: float = 0.0,
                  server_opt: str = "none", server_lr: float = 1.0,
                  n_malicious: int = 1) -> StrategyConfig:
    return StrategyConfig(name=name, fedprox_mu=fedprox_mu,
                          server_opt=server_opt, server_lr=server_lr,
                          n_malicious=int(n_malicious))


# ------------------------------------------------------------ state layout --

def _zeros_like(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-dim f32 tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def init_state(scfg: StrategyConfig, stacked_models: dict,
               global_models: dict) -> dict:
    """Strategy state for one federation: ``{}`` when the strategy is
    stateless. ``stacked_models`` / ``global_models`` are the client-group
    dicts (stacked leaves carry the leading C axis)."""
    out = {}
    if scfg.control:
        out["c_global"] = _zeros_like(global_models)
        out["c_local"] = _zeros_like(stacked_models)
    t = torch.zeros([], dtype=torch.int32,
                    device=tree_leaves(global_models)[0].device)
    if scfg.server_opt == "momentum":
        out["srv"] = {"m": _zeros_like(global_models), "t": t}
    elif scfg.server_opt == "adam":
        out["srv"] = {"m": _zeros_like(global_models),
                      "v": _zeros_like(global_models), "t": t}
    return out


def sample_state(state: dict, idx) -> dict:
    """Gather the sampled clients' rows of the stacked strategy trees
    ((C, ...) -> (K, ...)); unstacked entries (c_global, srv) pass
    through: the registry's "strat" block."""
    return round_state.sample_block("strat", state, idx)


def scatter_state(state: dict, sub: dict, idx) -> dict:
    """Write a sampled round's strategy state back: stacked rows scatter
    to the sampled positions, unstacked entries replace wholesale."""
    return round_state.scatter_block("strat", state, sub, idx)


# ------------------------------------------------------- client-side terms --

def client_term(scfg: StrategyConfig, grads: dict, params: dict,
                strat: dict | None) -> dict:
    """Additive gradient correction for one phase's group subset:

        g  +  mu * (w - anchor)  +  (c_global - c_local)

    ``strat`` carries ``anchor`` (each participant's round-start
    weights) for FedProx and ``c_global`` / ``c_local`` for SCAFFOLD.
    Unstacked c_global leaves broadcast against the stacked (C, ...)
    grads."""
    if strat is None or not scfg.client_active:
        return grads
    out = dict(grads)
    for grp in grads:
        g = out[grp]
        if scfg.prox:
            mu = scfg.fedprox_mu
            g = tree_map(lambda gg, p, a: gg + _f32(mu, gg) * (p.float() - a),
                         g, params[grp], strat["anchor"][grp])
        if scfg.control:
            g = tree_map(lambda gg, cg, cl: gg + (cg - cl),
                         g, strat["c_global"][grp], strat["c_local"][grp])
        out[grp] = g
    return out


# ------------------------------------------------- SCAFFOLD round update ----

def scaffold_round(scfg: StrategyConfig, c_global: dict, c_local: dict,
                   anchor: dict, trained: dict, steps: dict, lr: float,
                   frac: float):
    """Post-round control-variate update (SCAFFOLD Option II). Per
    participant i (the K gathered rows):

        c_i^+  =  c_i - c + (anchor_i - trained_i) / (steps * lr)
        c^+    =  c + frac * mean_i(c_i^+ - c_i)        frac = K / C

    ``steps`` maps each model group to the optimizer steps it took this
    round. Returns (c_global', c_local' rows); the caller scatters the
    rows back like opt moments. The scale is computed in f32 as the
    reference computes it: f32(1 / lr) / max(f32(steps), 1)."""
    inv_lr = torch.tensor(1.0 / float(lr), dtype=torch.float32)
    new_cl, new_cg = {}, {}
    for grp in trained:
        inv = inv_lr / torch.clamp_min(
            torch.tensor(float(steps[grp]), dtype=torch.float32), 1.0)
        cl = tree_map(
            lambda c, cg, a, t: c - cg + inv.to(c.device) * (a - t.float()),
            c_local[grp], c_global[grp], anchor[grp], trained[grp])
        new_cl[grp] = cl
        new_cg[grp] = tree_map(
            lambda cg, n, o: cg + _f32(frac, cg) * torch.mean(n - o, dim=0),
            c_global[grp], cl, c_local[grp])
    return new_cg, new_cl


# --------------------------------------------------- server-side optimizer --

def server_update(scfg: StrategyConfig, srv: dict, new_global: dict,
                  prev_global: dict):
    """Server optimizer on the blended delta (one step per round).

    delta = blend - prev_global is the server's "gradient" (FedOpt,
    Reddi et al. 2021). ``adam`` keeps bias-corrected first and second
    moments, ``momentum`` a running sum (FedAvgM). Returns (adjusted
    global tree dict, new srv state). A keep-global round contributes a
    zero delta: the moments decay instead of freezing."""
    if scfg.server_opt == "none":
        return new_global, srv
    delta = tree_map(lambda n, p: n.float() - p.float(), new_global,
                     prev_global)
    t = srv["t"] + 1
    lr, b1 = scfg.server_lr, SERVER_BETA1
    if scfg.server_opt == "momentum":
        m = tree_map(lambda mm, d: _f32(b1, mm) * mm + d, srv["m"], delta)
        out = tree_map(lambda p, mm: (p.float() + _f32(lr, mm) * mm
                                      ).to(p.dtype), prev_global, m)
        return out, {"m": m, "t": t}
    b2, eps = SERVER_BETA2, SERVER_EPS
    m = tree_map(lambda mm, d: _f32(b1, mm) * mm + (1 - _f32(b1, mm)) * d,
                 srv["m"], delta)
    v = tree_map(lambda vv, d: _f32(b2, vv) * vv
                 + (1 - _f32(b2, vv)) * torch.square(d), srv["v"], delta)
    bc1 = 1 - torch.pow(_f32(b1, t), t.float())
    bc2 = 1 - torch.pow(_f32(b2, t), t.float())
    out = tree_map(
        lambda p, mm, vv: (p.float() + _f32(lr, mm) * (mm / bc1)
                           / (torch.sqrt(vv / bc2) + _f32(eps, vv))
                           ).to(p.dtype), prev_global, m, v)
    return out, {"m": m, "v": v, "t": t}


# ------------------------------------------------- Byzantine-robust reducers --
#
# Reductions over a stacked candidate tree (leading axis = the n
# candidates). They ignore aggregation weights by design: robustness
# comes from order statistics and distance scores.

def coordinate_median_tree(stacked: dict) -> dict:
    """Coordinate-wise median of ``n`` stacked candidates, computed as
    ``jnp.median`` computes it: sort along the candidate axis, then
    (lower middle + upper middle) * 0.5 in f32, which at odd n is the
    middle value itself. ``torch.median`` would return the lower middle
    at even n, and ``torch.quantile`` refuses inputs over 2^24 elements."""
    def red(x):
        n = x.shape[0]
        s = torch.sort(x.float(), dim=0).values
        lo, hi = (n - 1) // 2, n // 2
        return ((s[lo] + s[hi]) * 0.5).to(x.dtype)

    return tree_map(red, stacked)


def trimmed_mean_tree(stacked: dict, trim: int) -> dict:
    """Coordinate-wise mean after dropping the ``trim`` largest and
    ``trim`` smallest values per coordinate. Needs n >= 2*trim + 1;
    callers route trim == 0 through the fedavg path."""
    def red(x):
        n = x.shape[0]
        if n <= 2 * trim:
            raise ValueError(
                f"trimmed mean needs > 2*trim candidates, got n={n} "
                f"with trim={trim}")
        s = torch.sort(x.float(), dim=0).values
        return torch.mean(s[trim:n - trim], dim=0).to(x.dtype)

    return tree_map(red, stacked)


def _flatten_candidates(stacked: dict) -> torch.Tensor:
    """(n, D) f32 matrix: every leaf of every candidate, flattened and
    concatenated; Krum scores distances in full parameter space."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    return torch.cat([leaf.float().reshape(n, -1) for leaf in leaves], dim=1)


def krum_scores(stacked: dict, f: int) -> torch.Tensor:
    """(n,) Krum scores (Blanchard et al. 2017): candidate i's score is
    the sum of squared distances to its n - f - 2 nearest peers (at least
    one). The distances use the reference's Gram form
    |a|^2 + |b|^2 - 2 a.b in f32: a direct |a - b|^2 rounds differently
    and could flip a survivor near a tie. The Gram product is an f32
    matmul; the port keeps TF32 off for matmuls (PyTorch's default), so
    on the card it is not rounded to TF32 either."""
    x = _flatten_candidates(stacked)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = torch.clamp_min(d2, 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    k = max(n - f - 2, 1)
    return torch.sum(torch.sort(d2, dim=1).values[:, :k], dim=1)


def krum_mask(stacked: dict, f: int) -> torch.Tensor:
    """(n,) f32 0/1 multi-Krum survivor mask: the m = n - f lowest
    scores (a stable sort, as ``jnp.argsort``). At f = 0 the mask is all
    ones whatever the scores, so krum is fedavg bit for bit."""
    x0 = tree_leaves(stacked)[0]
    n = x0.shape[0]
    m = max(n - f, 1)
    if m >= n:
        return torch.ones(n, dtype=torch.float32, device=x0.device)
    order = torch.argsort(krum_scores(stacked, f), stable=True)
    return torch.zeros(n, dtype=torch.float32, device=x0.device).index_fill(
        0, order[:m], 1.0)
