"""The port's BlendFL federation (Algorithm 1, full participation)
against the JAX reference on the CPU: the quickstart-shaped federation
(smnist, 3 clients, d_hidden=48, 2 layers, batch 64, lr 1e-2) from the
reference's initial weights, with the reference's per-phase shuffles
replayed from its key schedule.

Tolerances (f32 on the CPU, products summed in different orders):
phase losses rtol 1e-4; omegas atol 1e-3, and the kept-global outcome
of every group equal; global params rtol 1e-4, atol 1e-5;
``evaluate_global`` atol 1e-3. Under the lossy ``int8_topk`` codec a
last-ulp difference can flip a rare top-k or rounding decision, so its
global params are held to the run-level tolerance of ROADMAP fault (a):
all within 2e-2 and at least 99% within 1e-5.

BlendAvg's omegas follow from AUROC differences on the host, and a delta
near 0 could flip a mask between frameworks: the data seed is chosen so
that every candidate's delta in these runs is at least 1e-3 away from
0, and the test asserts that margin on the reference's scores.
"""
import jax
import numpy as np
import pytest

from _torch_parity import (
    DELTA_MARGIN,
    LOSS_RTOL,
    OMEGA_ATOL,
    PARAM_TOL,
    assert_trees_close,
    federation_pair,
    lossy_close,
)
from repro.core.federation import evaluate_global as jevaluate
from repro_torch.convert import params_to_numpy
from repro_torch.core.federation import evaluate_global

EVAL_ATOL = 1e-3
SEED = 0


def _run(monkeypatch, rounds, n_train=500, n_val=300, n_test=300, **kw):
    """Both federations side by side for ``rounds`` rounds. Returns
    (per-round (jax logs, port logs), the two federations, the two test
    sets, every (scores, global score) pair the reference blended on)."""
    logs, feds, seen, _, tests = federation_pair(
        monkeypatch, rounds, data_seed=SEED, n_clients=3, n_train=n_train,
        n_val=n_val, n_test=n_test, d_hidden=48, n_layers=2, **kw)
    return logs, feds, tests, seen


def _check_round(jl, tl):
    for k in ("loss_partial", "loss_vfl", "loss_paired"):
        assert np.isfinite(tl[k])
        np.testing.assert_allclose(tl[k], jl[k], rtol=LOSS_RTOL)
    assert jl.keys() == tl.keys()
    for k in ("omega_A", "omega_B", "omega_M"):
        np.testing.assert_allclose(tl[k], np.asarray(jl[k]), atol=OMEGA_ATOL)
        assert (np.sum(tl[k]) == 0) == (np.sum(np.asarray(jl[k])) == 0)


def _globals(jf, tf):
    return jax.tree.map(np.asarray, jf.global_models), params_to_numpy(tf.global_models)


def test_two_blendavg_rounds_track_jax(monkeypatch):
    logs, (jf, tf), (jte, tte), seen = _run(monkeypatch, rounds=2)
    assert len(seen) == 6  # A, B and M in each round
    for scores, glob in seen:
        d = scores - glob
        assert np.all(np.abs(d[np.isfinite(d)]) >= DELTA_MARGIN), (scores, glob)
    for jl, tl in logs:
        _check_round(jl, tl)
    jg, tg = _globals(jf, tf)
    assert_trees_close(jg, tg, **PARAM_TOL)
    assert_trees_close(jax.tree.map(np.asarray, jf.server_gmv),
                       params_to_numpy(tf.server_gmv), **PARAM_TOL)
    want, got = jevaluate(jf, jte), evaluate_global(tf, tte)
    assert want.keys() == got.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= EVAL_ATOL, k
    # the clients adopted the blend, each in storage of its own
    stacked = params_to_numpy(tf.stacked)
    np.testing.assert_array_equal(stacked["f_A"]["in"]["w"][2], tg["f_A"]["in"]["w"])
    np.testing.assert_array_equal(stacked["g_M"]["out"]["w"][1], tg["g_M"]["out"]["w"])
    w = tf.stacked["g_A"]["w"]
    assert w[0].data_ptr() != w[1].data_ptr()
    assert (tf.server_gmv["out"]["w"].data_ptr()
            != tf.global_models["g_M"]["out"]["w"].data_ptr())


@pytest.mark.parametrize("kw", [
    dict(strategy="fedavg"),
    dict(optimizer="adamw", weight_decay=0.01),
    dict(codec="int8_topk"),
], ids=["fedavg", "adamw", "int8_topk"])
def test_one_round_variant_tracks_jax(monkeypatch, kw):
    logs, (jf, tf), _, seen = _run(monkeypatch, rounds=1, n_train=300,
                                   n_val=200, n_test=10, **kw)
    for scores, glob in seen:
        d = scores - glob
        assert np.all(np.abs(d[np.isfinite(d)]) >= DELTA_MARGIN), (scores, glob)
    _check_round(*logs[0])
    jg, tg = _globals(jf, tf)
    if kw.get("codec"):
        lossy_close(jg, tg)
        assert tf.resid_up is not None and tf.resid_down is not None
        lossy_close(jax.tree.map(np.asarray, jf.resid_down),
                     params_to_numpy(tf.resid_down))
    else:
        assert_trees_close(jg, tg, **PARAM_TOL)
