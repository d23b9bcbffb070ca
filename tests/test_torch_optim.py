"""Task losses and functional optimizers of the PyTorch port against the
JAX reference, on the CPU.

The same numpy logits, labels, parameters and gradients go to both
sides. Tolerances: losses atol 1e-6 (both compute in f32 with the same
formula; ``logsumexp`` and ``log1p`` differ in the last ulp); five
optimizer steps rtol 1e-6, atol 1e-7 (elementwise f32 arithmetic, one
shared int32 step and f32 bias corrections on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import encoders as jenc
from repro.models import common as jcommon
from repro_torch import optim as topt
from repro_torch.convert import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import encoders as tenc
from repro_torch.models import common as tcommon

LOSS_ATOL = 1e-6
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _logits(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


def test_softmax_cross_entropy_matches_jax():
    logits = _logits(0, (4, 7, 10))
    labels = np.random.default_rng(1).integers(0, 10, (4, 7))
    want = jcommon.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tcommon.softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_ATOL)


def test_sigmoid_bce_matches_jax():
    logits = _logits(2, (6, 25))
    logits[0, :4] = [-60.0, 60.0, 0.0, -1e-3]  # saturated and centred entries
    targets = (np.random.default_rng(3).random((6, 25)) < 0.3).astype(np.float32)
    want = jcommon.sigmoid_bce(jnp.asarray(logits), jnp.asarray(targets))
    got = tcommon.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_ATOL)


@pytest.mark.parametrize("kind,out_dim", [("multiclass", 10), ("binary", 1),
                                          ("multilabel", 25)])
def test_task_loss_matches_jax(kind, out_dim):
    logits = _logits(4, (16, out_dim))
    rng = np.random.default_rng(5)
    if kind == "multiclass":
        y = np.eye(out_dim, dtype=np.float32)[rng.integers(0, out_dim, 16)]
    else:
        y = (rng.random((16, out_dim)) < 0.3).astype(np.float32)
    want = jenc.task_loss(jnp.asarray(logits), jnp.asarray(y), kind)
    got = tenc.task_loss(torch.from_numpy(logits), torch.from_numpy(y), kind)
    assert abs(float(got) - float(want)) <= LOSS_ATOL


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"enc": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                    "b": rng.standard_normal(3).astype(np.float32)},
            "hidden": [{"w": rng.standard_normal((3, 3)).astype(np.float32)}]}


def _grads(seed, params):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _pair(name, schedule, arg):
    """(JAX optimizer, port optimizer) of one configuration."""
    jlr = tlr = 0.05
    if schedule == "cosine":
        jlr, tlr = jopt.cosine_decay(0.05, 4), topt.cosine_decay(0.05, 4)
    if name == "sgd":
        return jopt.sgd(jlr, momentum=arg), topt.sgd(tlr, momentum=arg)
    return (jopt.adamw(jlr, weight_decay=arg),
            topt.adamw(tlr, weight_decay=arg))


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("name,arg", [("sgd", 0.0), ("sgd", 0.9),
                                      ("adamw", 0.0), ("adamw", 0.01)])
def test_five_steps_match_jax(name, arg, schedule):
    jo, to = _pair(name, schedule, arg)
    params = _params(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for t in range(5):  # five steps: past the cosine horizon of 4
        g = _grads(10 + t, params)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), **OPT_TOL),
                 jp, params_to_numpy(tp))
    jstate = jax.tree.map(np.asarray, js)
    tstate = opt_state_to_numpy(ts)
    assert tstate["step"] == jstate["step"] == 5
    assert tstate["step"].dtype == np.int32
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, a, **OPT_TOL),
                 jstate, tstate)


def test_schedules_match_jax():
    jcos, tcos = jopt.cosine_decay(0.1, 10), topt.cosine_decay(0.1, 10)
    for step in (0, 1, 5, 10, 12):
        want = float(jcos(jnp.asarray(step, jnp.int32)))
        got = float(tcos(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-9
    assert float(topt.constant(0.3)(torch.tensor(7, dtype=torch.int32))) == \
        float(jopt.constant(0.3)(jnp.asarray(7)))


def test_opt_state_carries_across_from_jax():
    """A JAX AdamW state (step 3, moments) crosses into the port with
    ``opt_state_from_numpy`` and back with ``opt_state_to_numpy``
    unchanged; stepping on from it tracks the reference."""
    params = _params(1)
    jo, to = jopt.adamw(0.01, weight_decay=0.01), topt.adamw(0.01, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    for t in range(3):
        ju, js = jo.update(jax.tree.map(jnp.asarray, _grads(t, params)), js, jp)
        jp = jopt.apply_updates(jp, ju)
    np_state = jax.tree.map(np.asarray, js)
    ts = opt_state_from_numpy(np_state, "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    jax.tree.map(np.testing.assert_array_equal, np_state, opt_state_to_numpy(ts))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    g = _grads(9, params)
    ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), **OPT_TOL),
                 jopt.apply_updates(jp, ju), params_to_numpy(topt.apply_updates(tp, tu)))
    with pytest.raises(ValueError, match="int32"):
        opt_state_from_numpy(dict(np_state, step=np.int64(3)), "cpu")
