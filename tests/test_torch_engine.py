"""Phase functions and phase drivers of the port's round engine against
the JAX reference, on the CPU, with C = 2 stacked clients (d_hidden=32,
one hidden layer).

The same numpy weights (the reference's init plus per-client noise),
batches and permutations go to both sides. Tolerance for params,
optimizer moments and losses: rtol 1e-5, atol 1e-5 (f32 matrix products
and their gradients summed in different orders by the two frameworks).
Eq. 9-10 run on the host in float64 in the port (``core.blendavg``, as
the reference's in-host federation runs them) and in f32 in the
reference's engine, so omegas are compared at 1e-6.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_close, jax_perms, unimodal_perms
from repro.core import encoders as jenc
from repro.core import engine as jeng
from repro.data.synthetic import make_task
from repro_torch.convert import (
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import encoders as tenc
from repro_torch.core import engine as teng
from repro_torch.core.federation import Federation

TOL = dict(rtol=1e-5, atol=1e-5)
C, B = 2, 8
SPEC = make_task("smnist")
OPTS = [dict(optimizer="sgd", momentum=0.9, lr=0.05),
        dict(optimizer="adamw", weight_decay=0.01, lr=0.01)]


def _cfgs(**opt):
    jcfg = jeng.EngineConfig(ecfg=jenc.EncoderConfig(d_hidden=32, n_layers=1),
                             kind=SPEC.kind, **opt)
    tcfg = teng.EngineConfig(ecfg=tenc.EncoderConfig(d_hidden=32, n_layers=1),
                             kind=SPEC.kind, **opt)
    return jcfg, tcfg


def _fns():
    jcfg, tcfg = _cfgs()
    return jeng.make_phase_fns(jcfg), teng.make_phase_fns(tcfg)


def _stacked_models(seed, n=C):
    """n clients: the reference's init plus per-client numpy noise on every
    leaf (biases and gains included)."""
    rng = np.random.default_rng(seed)
    base = jax.tree.map(np.asarray, jenc.init_client_models(
        jax.random.PRNGKey(seed), SPEC, jenc.EncoderConfig(d_hidden=32, n_layers=1)))
    return jax.tree.map(lambda x: np.stack(
        [x + 0.1 * rng.standard_normal(x.shape) for _ in range(n)]
    ).astype(np.float32), base)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _labels(rng, *lead):
    return np.eye(SPEC.out_dim, dtype=np.float32)[
        rng.integers(0, SPEC.out_dim, lead)]


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """The same models and optimizer state on both sides."""

    def __init__(self, opt, seed=0):
        self.jcfg, self.tcfg = _cfgs(**opt)
        self.jf, self.tf = jeng.make_phase_fns(self.jcfg), teng.make_phase_fns(self.tcfg)
        models = _stacked_models(seed)
        self.jm, self.tm = _j(models), params_from_numpy(models, "cpu")
        groups = {k: models[k] for k in jeng.CLIENT_GROUPS}
        self.js = self.jf.opt.init(_j(groups))
        self.ts = self.tf.opt.init(params_from_numpy(groups, "cpu"))

    def check(self):
        assert_trees_close(self.jm, params_to_numpy(self.tm), **TOL)
        jstate = _np(self.js)
        tstate = opt_state_to_numpy(self.ts)
        assert tstate["step"] == jstate["step"]
        assert_trees_close(jstate, tstate, **TOL)


def _uni_batch(rng, empty_a_client=None):
    batch = {"xa": _x(rng, C, B, SPEC.seq_a, SPEC.feat_a), "ya": _labels(rng, C, B),
             "ma": np.ones((C, B), np.float32),
             "xb": _x(rng, C, B, SPEC.seq_b, SPEC.feat_b), "yb": _labels(rng, C, B),
             "mb": np.ones((C, B), np.float32)}
    batch["ma"][0, B // 2:] = 0.0  # padded rows
    if empty_a_client is not None:
        batch["ma"][empty_a_client] = 0.0
    return batch


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adamw"])
def test_unimodal_step_matches_jax_and_skips_empty_clients(opt):
    p = Pair(opt)
    rng = np.random.default_rng(1)
    for empty in (None, 1):  # the second step: client 1 holds no A rows
        batch = _uni_batch(rng, empty)
        if empty is not None:
            kept = {k: params_to_numpy(p.tm[k]) for k in ("f_A", "g_A")}
            kept_state = opt_state_to_numpy(p.ts)
        p.jm, p.js, jinfo = jax.jit(p.jf.unimodal_step)(p.jm, p.js, _j(batch))
        p.tm, p.ts, tinfo = p.tf.unimodal_step(p.tm, p.ts,
                                               params_from_numpy(batch, "cpu"))
        p.check()
        for k in ("loss_a", "loss_b", "n_a", "n_b"):
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), **TOL)
    assert int(p.ts["step"]) == 2  # the shared step advanced for everyone
    assert float(tinfo["n_a"][1]) == 0.0
    moments = [f for f in ("mu", "nu", "mom") if f in kept_state]
    for k in ("f_A", "g_A"):  # client 1's A side: params AND moments kept
        now = params_to_numpy(p.tm[k])
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a[1], b[1]),
                     kept[k], now)
        for f in moments:
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a[1], b[1]),
                         kept_state[f][k], opt_state_to_numpy(p.ts)[f][k])


def _vfl_batch(rng, nfa=6, nfb=5):
    # aligned rows: a-side rows of both clients, b-side rows of client 0 only
    gather_a = np.array([0, 2, 7, 9, 11, 4], np.int32)
    gather_b = np.array([1, 0, 3, 4, 2, 1], np.int32)
    return {"xa": _x(rng, C, nfa, SPEC.seq_a, SPEC.feat_a),
            "xb": _x(rng, C, nfb, SPEC.seq_b, SPEC.feat_b),
            "gather_a": gather_a, "gather_b": gather_b,
            "y": _labels(rng, len(gather_a)),
            "part_a": np.array([True, True]), "part_b": np.array([True, False])}


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adamw"])
def test_vfl_step_matches_jax(opt):
    p = Pair(opt, seed=2)
    rng = np.random.default_rng(3)
    gmv = jax.tree.map(lambda x: np.asarray(x[0]), _stacked_models(4)["g_M"])
    jg, tg = _j(gmv), params_from_numpy(gmv, "cpu")
    jss, tss = p.jf.srv_opt.init(jg), p.tf.srv_opt.init(tg)
    batch = _vfl_batch(rng)
    before_b = params_to_numpy(p.tm["f_B"])
    p.jm, jg, p.js, jss, jloss = jax.jit(p.jf.vfl_step)(p.jm, jg, p.js, jss, _j(batch))
    tb = params_from_numpy({k: v for k, v in batch.items()
                            if not k.startswith("gather")}, "cpu")
    tb.update(gather_a=torch.from_numpy(batch["gather_a"]).long(),
              gather_b=torch.from_numpy(batch["gather_b"]).long())
    p.tm, tg, p.ts, tss, tloss = p.tf.vfl_step(p.tm, tg, p.ts, tss, tb)
    p.check()
    assert_trees_close(jg, params_to_numpy(tg), **TOL)
    assert_trees_close(_np(jss), opt_state_to_numpy(tss), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    # part_b is False for client 1: its B encoder did not move
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a[1], b[1]),
                 before_b, params_to_numpy(p.tm["f_B"]))


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adamw"])
def test_paired_step_matches_jax(opt):
    p = Pair(opt, seed=5)
    rng = np.random.default_rng(6)
    batch = {"xa": _x(rng, C, B, SPEC.seq_a, SPEC.feat_a),
             "xb": _x(rng, C, B, SPEC.seq_b, SPEC.feat_b),
             "y": _labels(rng, C, B), "m": np.ones((C, B), np.float32)}
    batch["m"][1] = 0.0  # client 1 holds no paired rows
    before = params_to_numpy(p.tm["g_M"])
    p.jm, p.js, jinfo = jax.jit(p.jf.paired_step)(p.jm, p.js, _j(batch))
    p.tm, p.ts, tinfo = p.tf.paired_step(p.tm, p.ts, params_from_numpy(batch, "cpu"))
    p.check()
    np.testing.assert_allclose(tinfo["loss"].numpy(), np.asarray(jinfo["loss"]), **TOL)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a[1], b[1]),
                 before, params_to_numpy(p.tm["g_M"]))


def _cands(seed, n):
    return {k: _stacked_models(seed, n)[k] for k in ("f_A", "g_A")}


@pytest.mark.parametrize("omega", [
    [0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.0, 0.5], [1 / 3, 2 / 3, 0.0, 0.0]],
    ids=["all", "zero_omega_drops", "f64_rounded_to_f32"])
def test_blend_stacked_matches_jax(omega):
    """Eq. 11 through the blend kernel's path (its plain version on the
    CPU) against the reference's Pallas blend in interpret mode."""
    jf, tf = _fns()
    cands = _cands(9, 4)
    want = jf.blend_stacked(_j(cands), np.asarray(omega))
    got = tf.blend_stacked(params_from_numpy(cands, "cpu"), np.asarray(omega))
    assert_trees_close(want, params_to_numpy(got), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gscore,improved", [(0.6, True), (0.7, False)],
                         ids=["improved", "kept_global"])
def test_blendavg_update_matches_jax(gscore, improved):
    """The reference engine's ``blendavg_update`` against the port's
    BlendAvg step as its round runs it (``Federation._blend_group``:
    host Eq. 9-10, then the blend), keep-global branch included."""
    jf, _ = _fns()
    owner = SimpleNamespace(engine=teng.RoundEngine(_cfgs()[1], B))
    cands = _cands(7, 3)
    glob = jax.tree.map(lambda x: x[0] * 0.5, cands)
    scores = np.array([0.62, 0.55, 0.66])
    jn, jo, jup = jf.blendavg_update(_j(glob), _j(cands), scores, gscore)
    tglob = params_from_numpy(glob, "cpu")
    tn, to = Federation._blend_group(owner, tglob, params_from_numpy(cands, "cpu"),
                                     scores, gscore, None)
    assert bool(jup) == (to.sum() > 0) == improved
    np.testing.assert_allclose(to, np.asarray(jo), rtol=1e-6, atol=1e-7)
    assert_trees_close(jn, params_to_numpy(tn), rtol=1e-6, atol=1e-6)
    if not improved:  # keep-global branch: the previous model itself
        assert tn is tglob


@pytest.mark.parametrize("w", [[3.0, 0.0, 1.0], [0.0, 0.0, 0.0]],
                         ids=["volume", "zero_keeps_global"])
def test_fedavg_update_matches_jax(w):
    jf, tf = _fns()
    cands = _cands(8, 3)
    glob = jax.tree.map(lambda x: x[1], cands)
    jn = jf.fedavg_update(_j(glob), _j(cands), np.asarray(w))
    tn = tf.fedavg_update(params_from_numpy(glob, "cpu"),
                          params_from_numpy(cands, "cpu"), np.asarray(w))
    assert_trees_close(jn, params_to_numpy(tn), rtol=1e-6, atol=1e-6)
    if not any(w):
        jax.tree.map(np.testing.assert_array_equal, glob, params_to_numpy(tn))


def test_broadcast_gives_each_client_its_own_storage():
    tf = teng.make_phase_fns(_cfgs()[1])
    glob = params_from_numpy(jax.tree.map(lambda x: x[0], _cands(10, 1)), "cpu")
    out = tf.broadcast(glob, 3)
    assert out["f_A"]["in"]["w"].shape == (3,) + tuple(glob["f_A"]["in"]["w"].shape)
    kept = glob["f_A"]["in"]["w"].clone()
    out["f_A"]["in"]["w"][0] += 1.0  # an in-place write to one client ...
    np.testing.assert_array_equal(out["f_A"]["in"]["w"][1].numpy(), kept.numpy())
    np.testing.assert_array_equal(glob["f_A"]["in"]["w"].numpy(), kept.numpy())


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adamw"])
def test_phase_drivers_match_jax(opt):
    """The minibatching drivers with the reference's per-client shuffles
    (drawn from the same key), and the stacked candidate scorers."""
    jcfg, tcfg = _cfgs(**opt)
    je, te = jeng.RoundEngine(jcfg, B), teng.RoundEngine(tcfg, B)
    models = _stacked_models(11)
    jm, tm = _j(models), params_from_numpy(models, "cpu")
    js, ts = je.init_opt_state(jm), te.init_opt_state(tm)
    rng = np.random.default_rng(12)
    n = 3 * B
    uni = {"xa": _x(rng, C, n, SPEC.seq_a, SPEC.feat_a), "ya": _labels(rng, C, n),
           "ma": np.ones((C, n), np.float32),
           "xb": _x(rng, C, n, SPEC.seq_b, SPEC.feat_b), "yb": _labels(rng, C, n),
           "mb": np.ones((C, n), np.float32)}
    uni["ma"][1, 5:] = 0.0  # a ragged client
    paired = {"xa": uni["xa"], "xb": uni["xb"], "y": uni["ya"],
              "m": np.ones((C, n), np.float32)}
    paired["m"][0] = 0.0  # a client without paired rows
    key = jax.random.PRNGKey(13)
    k1, k2 = jax.random.split(key)
    jm, js, jl1 = je.unimodal_phase(jm, js, _j(uni), k1)
    jm, js, jl2 = je.paired_phase(jm, js, _j(paired), k2)
    ia, ib = (torch.tensor(p).long() for p in unimodal_perms(k1, C, n))
    tm, ts, tl1 = te.unimodal_phase(tm, ts, params_from_numpy(uni, "cpu"), (ia, ib))
    tm, ts, tl2 = te.paired_phase(tm, ts, params_from_numpy(paired, "cpu"),
                                  torch.tensor(jax_perms(k2, C, n)).long())
    np.testing.assert_allclose([float(tl1), float(tl2)], [float(jl1), float(jl2)],
                               **TOL)
    assert_trees_close(jm, params_to_numpy(tm), **TOL)
    assert_trees_close(_np(js), opt_state_to_numpy(ts), **TOL)

    x_a = _x(rng, 10, SPEC.seq_a, SPEC.feat_a)
    x_b = _x(rng, 10, SPEC.seq_b, SPEC.feat_b)
    np.testing.assert_allclose(
        te.uni_scores(tm["f_A"], tm["g_A"], torch.from_numpy(x_a)).numpy(),
        np.asarray(je.uni_scores(jm["f_A"], jm["g_A"], jnp.asarray(x_a))), **TOL)
    f_a = jax.tree.map(lambda x: x[0], jm["f_A"])
    f_b = jax.tree.map(lambda x: x[1], jm["f_B"])
    np.testing.assert_allclose(
        te.multi_scores(params_from_numpy(_np(f_a), "cpu"),
                        params_from_numpy(_np(f_b), "cpu"), tm["g_M"],
                        torch.from_numpy(x_a), torch.from_numpy(x_b)).numpy(),
        np.asarray(je.multi_scores(f_a, f_b, jm["g_M"], jnp.asarray(x_a),
                                   jnp.asarray(x_b))), **TOL)


def test_phase_loss_is_nan_without_valid_rows():
    _, tcfg = _cfgs(**OPTS[0])
    te = teng.RoundEngine(tcfg, B)
    tm = params_from_numpy(_stacked_models(14), "cpu")
    rng = np.random.default_rng(15)
    paired = {"xa": _x(rng, C, B, SPEC.seq_a, SPEC.feat_a),
              "xb": _x(rng, C, B, SPEC.seq_b, SPEC.feat_b),
              "y": _labels(rng, C, B), "m": np.zeros((C, B), np.float32)}
    _, _, loss = te.paired_phase(tm, te.init_opt_state(tm),
                                 params_from_numpy(paired, "cpu"),
                                 torch.stack([torch.arange(B)] * C))
    assert torch.isnan(loss)
