"""The port's aggregation strategies (``repro_torch.core.aggregate`` and
the engine's strategy hooks) against the reference, on the CPU.

The same seeded numpy trees go to both sides. Tolerances:

- order statistics move values without arithmetic, and the median's
  (lower + upper middle) * 0.5 is one f32 operation on both sides:
  equal bit for bit;
- elementwise f32 arithmetic (client terms, SCAFFOLD's update, the
  server optimizers over 3 steps, the trimmed mean): rtol 1e-5,
  atol 1e-6 (XLA may fuse or reorder what torch evaluates step by step;
  Adam's pow differs in its last ulp);
- Krum's scores: each squared distance is |a|^2 + |b|^2 - 2 a.b in f32,
  a Gram product summed in another order on each side, whose rounding
  scales with the terms it cancels, not with the distance. A score is
  held to 8 f32 ulps (8 * 2^-23) of the Gram terms of its k nearest
  peers, sum over j of |a_i|^2 + |a_j|^2; the survivor masks equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_close
from repro.core import aggregate as jagg
from repro.core import encoders as jenc
from repro.core import engine as jeng
from repro.data.synthetic import make_task
from repro_torch.core import aggregate as tagg
from repro_torch.core import encoders as tenc
from repro_torch.core import engine as teng

TOL = dict(rtol=1e-5, atol=1e-6)
GROUPS = ("f_A", "g_A", "f_B", "g_B", "g_M")
C = 4
SPEC = make_task("smnist")


def _tree(rng, lead=(), scale=1.0):
    return {"w": (scale * rng.standard_normal(lead + (5, 3))).astype(np.float32),
            "hidden": [{"b": (scale * rng.standard_normal(lead + (3,))).astype(np.float32)}]}


def _groups(rng, lead=(), scale=1.0):
    return {g: _tree(rng, lead, scale) for g in GROUPS}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x), tree)


def _equal(want, got):
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b),
                                                            np.asarray(a)),
                 want, _np(got))


@pytest.mark.parametrize("server_opt", jagg.SERVER_OPTS)
@pytest.mark.parametrize("name", jagg.STRATEGIES)
def test_strategy_config_matches_reference(name, server_opt):
    mu = 0.1 if name == "fedprox" else 0.0
    j = jagg.make_strategy(name, mu, server_opt, 0.5, 2)
    t = tagg.make_strategy(name, mu, server_opt, 0.5, 2)
    jd = dataclasses.asdict(j)
    assert dataclasses.asdict(t) == {k: jd[k] for k in dataclasses.asdict(t)}
    # the reference's other fields: the port's constants, at their defaults
    assert (j.server_beta1, j.server_beta2, j.server_eps) == \
        (tagg.SERVER_BETA1, tagg.SERVER_BETA2, tagg.SERVER_EPS)
    assert set(jd) - set(dataclasses.asdict(t)) == {
        "server_beta1", "server_beta2", "server_eps"}
    for flag in ("prox", "control", "client_active", "stateful",
                 "score_based", "robust"):
        assert getattr(t, flag) == getattr(j, flag), flag


@pytest.mark.parametrize("kw", [dict(name="bogus"), dict(server_opt="sgd"),
                                dict(fedprox_mu=-1.0),
                                dict(name="fedavg", fedprox_mu=0.1),
                                dict(n_malicious=-1)])
def test_strategy_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        jagg.StrategyConfig(**kw)
    with pytest.raises(ValueError):
        tagg.StrategyConfig(**kw)


@pytest.mark.parametrize("name", ["fedprox", "scaffold", "fedavg"])
def test_client_term_matches_reference(name):
    rng = np.random.default_rng(1)
    scfg = dict(name=name, fedprox_mu=0.1 if name == "fedprox" else 0.0)
    grads, params = _groups(rng, (C,)), _groups(rng, (C,))
    strat = {"anchor": _groups(rng, (C,)), "c_global": _groups(rng),
             "c_local": _groups(rng, (C,))}
    want = jagg.client_term(jagg.StrategyConfig(**scfg), _j(grads),
                            _j(params), _j(strat))
    got = tagg.client_term(tagg.StrategyConfig(**scfg), _t(grads), _t(params),
                           _t(strat))
    assert_trees_close(want, _np(got), **TOL)
    if name == "fedavg":  # no client term: the grads themselves
        _equal(grads, got)


def test_scaffold_round_matches_reference():
    rng = np.random.default_rng(2)
    cg, cl = _groups(rng), _groups(rng, (C,))
    anchor, trained = _groups(rng, (C,)), _groups(rng, (C,))
    steps = {"f_A": 7.0, "f_B": 7.0, "g_A": 4.0, "g_B": 4.0, "g_M": 0.0}
    scfg = dict(name="scaffold")
    jcg, jcl = jagg.scaffold_round(jagg.StrategyConfig(**scfg), _j(cg), _j(cl),
                                   _j(anchor), _j(trained), steps, 0.03, 0.5)
    tcg, tcl = tagg.scaffold_round(tagg.StrategyConfig(**scfg), _t(cg), _t(cl),
                                   _t(anchor), _t(trained), steps, 0.03, 0.5)
    assert_trees_close(jcg, _np(tcg), **TOL)
    assert_trees_close(jcl, _np(tcl), **TOL)


@pytest.mark.parametrize("server_opt", ["adam", "momentum"])
def test_server_update_three_steps_matches_reference(server_opt):
    rng = np.random.default_rng(3)
    jcfg = jagg.make_strategy("fedavg", server_opt=server_opt, server_lr=0.7)
    tcfg = tagg.make_strategy("fedavg", server_opt=server_opt, server_lr=0.7)
    glob = _groups(rng)
    jsrv = jagg.init_state(jcfg, _j(_groups(rng, (C,))), _j(glob))["srv"]
    tsrv = tagg.init_state(tcfg, _t(_groups(rng, (C,))), _t(glob))["srv"]
    _equal(jsrv, tsrv)
    jprev, tprev = _j(glob), _t(glob)
    for step in range(3):
        new = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape)
                           .astype(np.float32), _np(jprev))
        jprev, jsrv = jagg.server_update(jcfg, jsrv, _j(new), jprev)
        tprev, tsrv = tagg.server_update(tcfg, tsrv, _t(new), tprev)
        assert int(tsrv["t"]) == int(jsrv["t"]) == step + 1
        assert tsrv["t"].dtype == torch.int32
        assert_trees_close(jprev, _np(tprev), **TOL)
        assert_trees_close({k: v for k, v in jsrv.items() if k != "t"},
                           _np({k: v for k, v in tsrv.items() if k != "t"}),
                           **TOL)
    none = tagg.make_strategy("fedavg")
    out, srv = tagg.server_update(none, {}, tprev, tprev)
    assert out is tprev and srv == {}


@pytest.mark.parametrize("name,server_opt", [("scaffold", "adam"),
                                             ("fedavg", "momentum"),
                                             ("fedprox", "none"),
                                             ("krum", "none")])
def test_init_sample_scatter_state_match_reference(name, server_opt):
    mu = 0.1 if name == "fedprox" else 0.0
    jcfg = jagg.make_strategy(name, mu, server_opt)
    tcfg = tagg.make_strategy(name, mu, server_opt)
    rng = np.random.default_rng(4)
    stacked, glob = _groups(rng, (C,)), _groups(rng)
    jst = jagg.init_state(jcfg, _j(stacked), _j(glob))
    tst = tagg.init_state(tcfg, _t(stacked), _t(glob))
    assert jst.keys() == tst.keys() and bool(tst) == tcfg.stateful
    _equal(jst, tst)
    # fill the state with values, then gather and scatter by ids
    filled = jax.tree.map(lambda x: (x + rng.standard_normal(x.shape)).astype(
        np.asarray(x).dtype) if np.asarray(x).ndim else np.asarray(x), _np(tst))
    idx = [3, 1]
    jsub = jagg.sample_state(_j(filled), jnp.asarray(idx, jnp.int32))
    tsub = tagg.sample_state(_t(filled), torch.tensor(idx))
    _equal(jsub, tsub)
    moved = jax.tree.map(lambda x: x + np.asarray(1, x.dtype), _np(tsub))
    want = jagg.scatter_state(_j(filled), _j(moved), jnp.asarray(idx, jnp.int32))
    tfilled = _t(filled)
    got = tagg.scatter_state(tfilled, _t(moved), torch.tensor(idx))
    _equal(want, got)
    _equal(filled, tfilled)  # the state given is not written


@pytest.mark.parametrize("n", [5, 4, 2, 1], ids=["odd", "even", "two", "one"])
def test_coordinate_median_matches_jnp_median(n):
    rng = np.random.default_rng(5 + n)
    stacked = {"a": rng.standard_normal((n, 33, 7)).astype(np.float32),
               "b": [{"c": np.round(rng.standard_normal((n, 10)), 1)
                      .astype(np.float32)}]}  # ties
    want = jagg.coordinate_median_tree(_j(stacked))
    got = tagg.coordinate_median_tree(_t(stacked))
    _equal(want, got)
    if n == 4:  # torch.median would take the lower middle here
        low = torch.median(torch.from_numpy(stacked["a"]), dim=0).values
        assert not torch.equal(low, got["a"])


def test_trimmed_mean_matches_reference():
    rng = np.random.default_rng(6)
    stacked = _groups(rng, (5,))
    for trim in (1, 2):
        want = jagg.trimmed_mean_tree(_j(stacked), trim)
        got = tagg.trimmed_mean_tree(_t(stacked), trim)
        assert_trees_close(want, _np(got), **TOL)
    with pytest.raises(ValueError, match="trimmed mean needs"):
        tagg.trimmed_mean_tree(_t(stacked), 3)


def _cohort(rng, n, outliers=1):
    """n candidates around a common mean; the last ``outliers`` scaled
    by 100, so Krum's survivors are clear."""
    base = _groups(rng)
    out = jax.tree.map(lambda x: np.stack(
        [x + 0.1 * rng.standard_normal(x.shape) for _ in range(n)]
    ).astype(np.float32), base)
    return jax.tree.map(lambda x: np.concatenate(
        [x[: n - outliers], 100.0 * x[n - outliers:]]), out)


@pytest.mark.parametrize("n,f", [(5, 1), (4, 1), (6, 2), (3, 0)])
def test_krum_scores_and_mask_match_reference(n, f):
    stacked = _cohort(np.random.default_rng(7 + n), n, max(f, 1))
    want = np.asarray(jagg.krum_scores(_j(stacked), f))
    got = tagg.krum_scores(_t(stacked), f).numpy()
    flat = np.asarray(jagg._flatten_candidates(_j(stacked)), np.float64)
    sq = np.sum(flat * flat, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2 * flat @ flat.T
    np.fill_diagonal(d2, np.inf)
    k = max(n - f - 2, 1)
    near = np.argsort(d2, axis=1)[:, :k]
    gram = k * sq + sq[near].sum(axis=1)
    assert np.all(np.abs(got - want) <= 8 * np.finfo(np.float32).eps * gram), \
        (got, want, gram)
    np.testing.assert_array_equal(
        tagg.krum_mask(_t(stacked), f).numpy(),
        np.asarray(jagg.krum_mask(_j(stacked), f)))
    np.testing.assert_array_equal(
        tagg._flatten_candidates(_t(stacked)).numpy(),
        np.asarray(jagg._flatten_candidates(_j(stacked))))
    if f == 0:
        np.testing.assert_array_equal(tagg.krum_mask(_t(stacked), 0).numpy(),
                                      np.ones(n, np.float32))


def _engines(name, n_malicious=1):
    def cfg(eng, enc):
        return eng.EngineConfig(
            ecfg=enc.EncoderConfig(d_hidden=32, n_layers=1), kind=SPEC.kind,
            strategy=(jagg if eng is jeng else tagg).make_strategy(
                name, n_malicious=n_malicious))
    return (jeng.make_phase_fns(cfg(jeng, jenc)),
            teng.make_phase_fns(cfg(teng, tenc)))


@pytest.mark.parametrize("name", ["median", "trimmed_mean", "krum"])
def test_robust_update_matches_reference(name):
    jf, tf = _engines(name)
    rng = np.random.default_rng(8)
    cands = _cohort(rng, 5)
    glob = jax.tree.map(lambda x: x[0] * 0.5, cands)
    w = np.asarray([3.0, 1.0, 0.0, 2.0, 5.0])
    jnew, jom = jf.robust_update(_j(glob), _j(cands), w)
    tnew, tom = tf.robust_update(_t(glob), _t(cands), w)
    np.testing.assert_allclose(tom.numpy(), np.asarray(jom), rtol=1e-6)
    if name == "median":
        _equal(jnew, tnew)
    else:
        assert_trees_close(jnew, _np(tnew), **TOL)
    with pytest.raises(ValueError, match="not a robust strategy"):
        _engines("fedavg")[1].robust_update(_t(glob), _t(cands), w)


@pytest.mark.parametrize("name", ["krum", "trimmed_mean"])
def test_robust_at_zero_malicious_is_fedavg_bit_for_bit(name):
    """At n_malicious = 0 krum's mask is all ones and trimmed_mean trims
    nothing: both reduce through the fedavg path, bit for bit (krum with
    the volume weights, trimmed_mean with uniform ones)."""
    _, tf = _engines(name, n_malicious=0)
    _, tfed = _engines("fedavg")
    cands = _cohort(np.random.default_rng(9), 5)
    glob = jax.tree.map(lambda x: x[0], cands)
    w = np.asarray([3.0, 1.0, 4.0, 2.0, 5.0])
    new, om = tf.robust_update(_t(glob), _t(cands), w)
    want = tfed.fedavg_update(_t(glob), _t(cands),
                              w if name == "krum" else np.full(5, 0.2))
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 want, new)
    if name == "krum":
        np.testing.assert_array_equal(om.numpy(),
                                      (w / w.sum()).astype(np.float32))
