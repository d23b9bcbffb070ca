"""The port's split (VFL) helpers (``repro_torch.core.vfl``) against the
reference's on the same weights and batches, and the wire protocol
against joint autodiff in the port. The reference's whole-step
``vfl_step`` / ``vfl_step_split`` are not ported (nothing but tests calls
them); ``_port_joint`` and ``_port_split`` compose the same steps from
the port's helpers.

Tolerances: port against reference 1e-6 absolute + 1e-5 relative
(different autodiff, one float32 backward), 1e-5 absolute for
``client_backward`` under a unit-normal cotangent (16 rows of O(1)
terms summed in another order); split against joint in the port 1e-6
absolute + 1e-5 relative, the reference's own test's bound;
``build_vfl_batches`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vfl as jvfl
from repro.core.encoders import EncoderConfig as JEnc, encoder_init, fusion_init
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import vfl as tvfl
from repro_torch.core.encoders import EncoderConfig, encoder_apply
from repro_torch.core.engine import value_and_grad

TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ("multiclass", "multilabel")


def _setup(seed=0, n=16, kind="multiclass"):
    rng = np.random.default_rng(seed)
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    jcfg = JEnc(d_hidden=32, n_layers=2, enc_type="mlp")
    params = jax.tree.map(np.asarray, {
        "f_a": encoder_init(ks[0], 6, jcfg), "f_b": encoder_init(ks[1], 5, jcfg),
        "gmv": fusion_init(ks[2], 32, 3)})
    y = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)] if kind == "multiclass"
         else rng.integers(0, 2, (n, 3)).astype(np.float32))
    batch = dict(x_a=rng.normal(0, 1, (n, 4, 6)).astype(np.float32),
                 x_b=rng.normal(0, 1, (n, 7, 5)).astype(np.float32), y=y,
                 owner_a=np.zeros(n), owner_b=np.ones(n))
    return (params, jvfl.VflBatch(**batch), tvfl.VflBatch(**batch),
            params_from_numpy(params, "cpu"),
            EncoderConfig(d_hidden=32, n_layers=2, enc_type="mlp"), jcfg)


def _close(want, got, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **(tol or TOL)),
        want, params_to_numpy(got) if not isinstance(got, np.ndarray) else got)


def _tensors(b):
    return (torch.from_numpy(b.x_a), torch.from_numpy(b.x_b), torch.from_numpy(b.y))


def _port_joint(tp, b, cfg, kind):
    """One joint backward through both encoders and the server loss (the
    reference's ``vfl_step``)."""
    x_a, x_b, y = _tensors(b)

    def joint(p):
        loss = tvfl.server_loss(p[2], encoder_apply(p[0], x_a, cfg),
                                encoder_apply(p[1], x_b, cfg), y, kind)
        return loss, loss

    loss, (g_fa, g_fb, g_srv) = value_and_grad(joint, (tp["f_a"], tp["f_b"], tp["gmv"]))
    return loss, {"f_A": g_fa, "f_B": g_fb, "g_M_v": g_srv}


def _port_split(tp, b, cfg, kind):
    """The literal wire protocol, forward up and cotangents down (the
    reference's ``vfl_step_split``)."""
    x_a, x_b, y = _tensors(b)
    with torch.no_grad():
        h_a = tvfl.client_forward(tp["f_a"], x_a, cfg)
        h_b = tvfl.client_forward(tp["f_b"], x_b, cfg)
    loss, g_srv, g_ha, g_hb = tvfl.server_forward_backward(tp["gmv"], h_a, h_b, y, kind)
    return loss, {"f_A": tvfl.client_backward(tp["f_a"], x_a, g_ha, cfg),
                  "f_B": tvfl.client_backward(tp["f_b"], x_b, g_hb, cfg),
                  "g_M_v": g_srv}


PORT_STEPS = {"vfl_step": _port_joint, "vfl_step_split": _port_split}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", ["vfl_step", "vfl_step_split"])
def test_steps_match_reference(step, kind):
    p, jb, tb, tp, tcfg, jcfg = _setup(1, kind=kind)
    l1, g1 = getattr(jvfl, step)(p["f_a"], p["f_b"], p["gmv"], jb, jcfg, kind)
    l2, g2 = PORT_STEPS[step](tp, tb, tcfg, kind)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    assert sorted(g2) == sorted(g1) == ["f_A", "f_B", "g_M_v"]
    for k in g1:
        _close(g1[k], g2[k])


@pytest.mark.parametrize("kind", KINDS)
def test_split_passes_match_reference(kind):
    p, jb, _, tp, tcfg, jcfg = _setup(2, kind=kind)
    x = torch.from_numpy(jb.x_a)
    h_j = jvfl.client_forward(p["f_a"], jnp.asarray(jb.x_a), jcfg)
    h_t = tvfl.client_forward(tp["f_a"], x, tcfg)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), **TOL)
    h_b = jvfl.client_forward(p["f_b"], jnp.asarray(jb.x_b), jcfg)
    want = jvfl.server_forward_backward(p["gmv"], h_j, h_b, jnp.asarray(jb.y), kind)
    ha_t, hb_t = (torch.from_numpy(np.array(h)) for h in (h_j, h_b))
    got = tvfl.server_forward_backward(tp["gmv"], ha_t, hb_t,
                                       torch.from_numpy(jb.y), kind)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(tvfl.server_loss(
        tp["gmv"], ha_t, hb_t, torch.from_numpy(jb.y), kind)), float(want[0]), rtol=1e-6)
    _close(want[1], got[1])
    for a, b in zip(want[2:], got[2:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    cot = np.random.default_rng(3).standard_normal((len(jb.y), 32)).astype(np.float32)
    _close(jvfl.client_backward(p["f_a"], jnp.asarray(jb.x_a), jnp.asarray(cot), jcfg),
           tvfl.client_backward(tp["f_a"], x, torch.from_numpy(cot), tcfg),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 4])
def test_split_equals_joint_autodiff(seed):
    _, _, tb, tp, tcfg, _ = _setup(seed)
    l1, g1 = _port_joint(tp, tb, tcfg, "multiclass")
    l2, g2 = _port_split(tp, tb, tcfg, "multiclass")
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for k in ("f_A", "f_B", "g_M_v"):
        for a, b in zip(tree_leaves(g1[k]), tree_leaves(g2[k])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_client_backward_leaves_params_untouched():
    """The vjp runs over fresh leaf copies: the caller's tensors record
    no graph and keep their values."""
    _, jb, _, tp, tcfg, _ = _setup(5)
    before = params_to_numpy(tp["f_a"])
    g = tvfl.client_backward(tp["f_a"], torch.from_numpy(jb.x_a),
                             torch.ones(len(jb.y), 32), tcfg)
    assert all(not x.requires_grad and x.grad is None for x in tree_leaves(tp["f_a"]))
    assert all(not x.requires_grad for x in tree_leaves(g))
    jax.tree.map(np.testing.assert_array_equal, before, params_to_numpy(tp["f_a"]))


@pytest.mark.parametrize("batch_size", [7, 16])
def test_build_vfl_batches_bit_for_bit(batch_size):
    from repro.core.partitioner import partition as jpartition
    from repro.data.synthetic import generate as jgenerate, make_task as jmake
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import generate, make_task

    want = jvfl.build_vfl_batches(jpartition(jgenerate(jmake("smnist"), 200, seed=0),
                                             3, seed=0),
                                  batch_size, np.random.default_rng(0))
    got = tvfl.build_vfl_batches(partition(generate(make_task("smnist"), 200, seed=0),
                                           3, seed=0),
                                 batch_size, np.random.default_rng(0))
    assert len(got) == len(want) > 1
    for a, b in zip(want, got):
        for f in ("x_a", "x_b", "y", "owner_a", "owner_b"):
            x, z = getattr(a, f), getattr(b, f)
            assert x.dtype == z.dtype
            np.testing.assert_array_equal(z, x)
        assert (b.owner_a != b.owner_b).all()


def test_align_by_id():
    ia = np.array([10, 3, 7, 99])
    ib = np.array([7, 11, 3])
    for m in (jvfl, tvfl):
        common, ra, rb = m.align_by_id(ia, ib)
        np.testing.assert_array_equal(common, [3, 7])
        np.testing.assert_array_equal(ia[ra], common)
        np.testing.assert_array_equal(ib[rb], common)


def test_public_names_match_reference():
    """Every public name of the reference's but its two test-only steps."""
    names = lambda m: {k for k, v in vars(m).items() if not k.startswith("_")
                       and getattr(v, "__module__", None) == m.__name__}
    assert names(tvfl) == names(jvfl) - {"vfl_step", "vfl_step_split"}
