"""K-of-C sampled and async BlendFL rounds of the port against the JAX
reference on the CPU: ``Federation`` with ``n_sampled``, synchronous and
async (staleness-damped Eq. 9-10, broadcast to the participants only),
under the ``int8_topk`` codec, and the pieces those rounds add: the
async Eq. 9-11 (the round's host ``blendavg_weights`` and
``Federation._blend_group`` against the reference engine's
``omega_from_scores`` / ``blendavg_update`` with ``staleness`` and
``finished``), the omega EMA the federation folds (against the
reference's ``ema_update``), and ``vfl_step`` with row weights ``w``.

Federation runs (``_torch_parity.federation_pair``: smnist, 4 clients,
d_hidden=32, one hidden layer, the reference's weights and shuffles):
sampled ids and ``last_round`` / ``part_count`` equal; losses rtol 1e-4;
omegas and ``omega_ema`` atol 1e-3 with the same keep-global outcome;
global params and the server head rtol 1e-4, atol 1e-5; under
``int8_topk`` the run-level tolerance of ROADMAP fault (a). The data
seed of each run keeps every BlendAvg delta at least 1e-3 from 0
(fault (d)), asserted on the reference's scores. The port's omega EMA,
replayed from its own omegas through the reference's f32
``ema_update``, is held to 1e-6 (f64 against f32 of values in [0, 1]).

Eq. 9-11 pieces: omegas atol 2^-21, four f32 ulps of 1 (the port's Eq.
9-10 in f64, the reference's in f32); params, moments and losses rtol
1e-5, atol 1e-5 (as ``test_torch_engine.py``).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_federations_close,
    assert_margins,
    assert_round_close,
    assert_trees_close,
    federation_pair,
    lossy_close,
)
from repro.core import engine as jeng
from repro.core import schedule as jsched
from repro_torch.convert import opt_state_to_numpy, params_from_numpy, params_to_numpy
from repro_torch.core import engine as teng
from repro_torch.core.blendavg import blendavg_weights
from repro_torch.core.federation import EMA_BETA, Federation
from test_torch_engine import OPTS, TOL, Pair, _cands, _cfgs, _j, _np, _stacked_models, _vfl_batch

OMEGA_F32 = 2.0 ** -21


def _staleness(logs):
    """Each round's staleness of its sampled ids, replayed from the ids:
    ``round - 1 - last_round``, floored at 0; async rounds sync only
    their participants."""
    last = np.full(4, -1)
    out = []
    for r, (jl, _) in enumerate(logs):
        ids = np.asarray(jl["sampled"])
        out.append(np.maximum(r - 1 - last[ids], 0))
        last[ids] = r
    return out


@pytest.mark.parametrize("rounds,data_seed,kw", [
    (2, 0, dict(n_sampled=2)),
    (3, 0, dict(n_sampled=2, async_mode=True, lr=0.05)),
], ids=["sampled_sync", "async_3_rounds"])
def test_sampled_rounds_track_jax(monkeypatch, rounds, data_seed, kw):
    logs, (jf, tf), seen, *_ = federation_pair(monkeypatch, rounds,
                                              data_seed=data_seed, **kw)
    assert_margins(seen)
    for jl, tl in logs:
        assert_round_close(jl, tl)
        assert len(tl["sampled"]) == 2
    assert_federations_close(jf, tf)
    if kw.get("async_mode"):
        assert max(s.max() for s in _staleness(logs)) > 0  # damping ran
        # stragglers kept their stale weights: the stacked rows match
        assert_trees_close(jax.tree.map(np.asarray, jf.stacked),
                           params_to_numpy(tf.stacked), rtol=1e-4, atol=1e-5)
        assert (tf.last_round < rounds - 1).any()
    else:
        np.testing.assert_array_equal(tf.last_round, rounds - 1)
    # the EMA the port folds, against the reference's f32 fold of the
    # port's own omegas (the server slot of omega_M excluded)
    assert EMA_BETA == jf.cfg.ema_beta
    ema = jnp.zeros(4, jnp.float32)
    for _, tl in logs:
        heads = [np.asarray(tl[k]) for k in ("omega_A", "omega_B") if k in tl]
        heads.append(np.asarray(tl["omega_M"])[:2])
        ema = jsched.ema_update(ema, np.mean(heads, axis=0), EMA_BETA,
                                jnp.asarray(tl["sampled"], jnp.int32))
    np.testing.assert_allclose(tf.omega_ema, np.asarray(ema), rtol=0, atol=1e-6)


def test_sampled_async_int8_topk_round_tracks_jax(monkeypatch):
    logs, (jf, tf), seen, *_ = federation_pair(
        monkeypatch, 2, data_seed=3, n_sampled=2, async_mode=True,
        codec="int8_topk", lr=0.05)
    assert_margins(seen)
    for jl, tl in logs:
        assert_round_close(jl, tl)
    assert_federations_close(jf, tf, lossy=True)
    lossy_close(jax.tree.map(np.asarray, jf.resid_up),
                params_to_numpy(tf.resid_up))
    lossy_close(jax.tree.map(np.asarray, jf.resid_down),
                params_to_numpy(tf.resid_down))
    # only the participants' residual rows moved
    never = np.setdiff1d(np.arange(4), np.concatenate(
        [np.asarray(jl["sampled"]) for jl, _ in logs]))
    for leaf in jax.tree.leaves(params_to_numpy(tf.resid_up)):
        assert not leaf[never].any()


# ------------------------------------------------------ Eq. 9-11 pieces --

@pytest.mark.parametrize("staleness,finished", [
    (None, None), (np.array([0, 2, 1, 5]), None),
    (None, np.array([True, False, True, True])),
    (np.array([3, 0, 1, 0]), np.array([True, True, False, True]))],
    ids=["plain", "stale", "unfinished", "both"])
@pytest.mark.parametrize("gscore", [0.6, 0.9], ids=["improved", "none_improved"])
def test_host_omegas_match_jax_omega_from_scores(staleness, finished, gscore):
    """The round's Eq. 9-10 (host ``blendavg_weights``; a candidate that
    did not finish arrives with score -inf) against the reference
    engine's device-side ``omega_from_scores`` with ``finished``."""
    jf = jeng.make_phase_fns(_cfgs()[0])
    scores = np.asarray([0.62, 0.55, 0.71, np.nan])
    jo, jup = jf.omega_from_scores(jnp.asarray(scores, jnp.float32), gscore,
                                   staleness, finished)
    masked = scores if finished is None else np.where(finished, scores, -np.inf)
    host = blendavg_weights(masked, gscore, staleness=staleness)
    np.testing.assert_allclose(host, np.asarray(jo), rtol=0, atol=OMEGA_F32)
    assert (host.sum() > 0) == bool(jup) == (gscore < 0.71)


def test_blend_group_with_staleness_matches_jax_blendavg_update():
    """The round's async BlendAvg step (``Federation._blend_group`` with
    staleness; the unfinished candidate scored -inf) against the
    reference's ``blendavg_update`` with staleness and finished, the
    keep-global branch included."""
    jf = jeng.make_phase_fns(_cfgs()[0])
    owner = SimpleNamespace(engine=teng.RoundEngine(_cfgs()[1], 8))
    cands = _cands(21, 3)
    glob = jax.tree.map(lambda x: x[0] * 0.5, cands)
    scores, stale = np.asarray([0.7, 0.65, 0.8]), np.asarray([2, 0, 1])
    fin = np.asarray([True, True, False])
    masked = np.where(fin, scores, -np.inf)
    tglob, tcands = params_from_numpy(glob, "cpu"), params_from_numpy(cands, "cpu")
    jn, jo, jup = jf.blendavg_update(_j(glob), _j(cands), scores, 0.6, stale, fin)
    tn, to = Federation._blend_group(owner, tglob, tcands, masked, 0.6, None,
                                     staleness=stale)
    np.testing.assert_allclose(to, np.asarray(jo), rtol=0, atol=OMEGA_F32)
    assert bool(jup) and to[2] == 0.0
    assert_trees_close(jn, params_to_numpy(tn), rtol=1e-6, atol=1e-6)
    # nothing improves: the previous global model itself
    _, jo, jup = jf.blendavg_update(_j(glob), _j(cands), scores, 0.9, stale, fin)
    tn, to = Federation._blend_group(owner, tglob, tcands, masked, 0.9, None,
                                     staleness=stale)
    assert not bool(jup) and not to.any() and tn is tglob


@pytest.mark.parametrize("w", [[1, 0, 1, 1, 0, 1], [0, 0, 0, 0, 0, 0]],
                         ids=["some_rows", "no_live_row"])
@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adamw"])
def test_vfl_step_with_row_weights_matches_jax(opt, w):
    """A sampled round's VFL batch: rows of unsampled owners weigh 0.
    With no live row the server head and its optimizer state stay as
    they were (AdamW would otherwise decay and step them)."""
    p = Pair(opt, seed=2)
    rng = np.random.default_rng(3)
    gmv = jax.tree.map(lambda x: np.asarray(x[0]), _stacked_models(4)["g_M"])
    jg, tg = _j(gmv), params_from_numpy(gmv, "cpu")
    jss, tss = p.jf.srv_opt.init(jg), p.tf.srv_opt.init(tg)
    batch = _vfl_batch(rng)
    batch["w"] = np.asarray(w, np.float32)
    if not any(w):
        batch["part_a"] = batch["part_b"] = np.array([False, False])
    p.jm, jg, p.js, jss2, jloss = jax.jit(p.jf.vfl_step)(p.jm, jg, p.js, jss,
                                                         _j(batch))
    tb = params_from_numpy({k: v for k, v in batch.items()
                            if not k.startswith("gather")}, "cpu")
    tb.update(gather_a=torch.from_numpy(batch["gather_a"]).long(),
              gather_b=torch.from_numpy(batch["gather_b"]).long())
    before = params_to_numpy(tg)
    p.tm, tg2, p.ts, tss2, tloss = p.tf.vfl_step(p.tm, tg, p.ts, tss, tb)
    p.check()
    assert_trees_close(jg, params_to_numpy(tg2), **TOL)
    assert_trees_close(_np(jss2), opt_state_to_numpy(tss2), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    if not any(w):
        assert float(tloss) == 0.0
        jax.tree.map(np.testing.assert_array_equal, before, params_to_numpy(tg2))
        assert int(tss2["step"]) == int(tss["step"])
