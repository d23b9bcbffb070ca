"""Encoders (mlp, recurrent, transformer), heads and fusion of the
PyTorch port against the JAX reference, on the CPU, plus the weight
converter and the port's initialisers.

Weights start from the reference's init, then every leaf gets numpy
noise (biases and rmsnorm gains included: at init they are zero and one,
which would hide a bias or gain bug) and the same numpy tree goes to
both sides. Tolerance for f32 on the CPU: rtol=1e-5, atol=1e-5 (the two
frameworks' matrix products sum in different orders); the recurrent and
transformer encoders rtol=1e-4, atol=1e-5 (the sLSTM carries its
differences through S steps; the attention kernel's scale 1 / sqrt(hd)
differs from the reference's division by sqrt(hd) by an ulp when hd is
not a power of 4, and its online softmax rescales tile by tile).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as jenc
from repro.data.synthetic import make_task as jax_make_task
from repro.models import common as jcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import encoders as tenc
from repro_torch.data.synthetic import make_task
from repro_torch.models import common as tcommon

TOL = dict(rtol=1e-5, atol=1e-5)


def noisy_numpy_models(spec, ecfg, seed):
    """JAX-initialised client models with numpy noise on every leaf."""
    rng = np.random.default_rng(seed)
    models = jenc.init_client_models(jax.random.PRNGKey(seed), spec, ecfg)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                   ).astype(np.float32), models)


def flat_keys(tree):
    """The flat ``/``-keyed form of a numpy tree, as a checkpoint's
    arrays.npz stores it."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def both(spec_name, d_hidden, n_layers, seed, enc_type="mlp", flat=False):
    spec = jax_make_task(spec_name)
    jcfg = jenc.EncoderConfig(d_hidden=d_hidden, n_layers=n_layers,
                              enc_type=enc_type)
    tcfg = tenc.EncoderConfig(d_hidden=d_hidden, n_layers=n_layers,
                              enc_type=enc_type)
    np_models = noisy_numpy_models(spec, jcfg, seed)
    jmodels = jax.tree.map(jnp.asarray, np_models)
    tmodels = params_from_numpy(flat_keys(np_models) if flat else np_models,
                                "cpu")
    return spec, jcfg, tcfg, jmodels, tmodels


CONFIGS = [("smnist", 32, 1), ("conditions", 48, 2)]
VARIANT_TOL = dict(rtol=1e-4, atol=1e-5)


def test_task_specs_match_reference():
    for name in ("conditions", "mortality", "smnist"):
        assert make_task(name).__dict__ == jax_make_task(name).__dict__
        assert make_task(name).out_dim == jax_make_task(name).out_dim


@pytest.mark.parametrize("task,d,layers", CONFIGS)
def test_encoders_heads_fusion_match_jax(task, d, layers):
    _check_models_match_jax(*both(task, d, layers, seed=1), TOL)


@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
@pytest.mark.parametrize("task,d,layers,flat", [
    ("smnist", 32, 1, False),      # hd = 8
    ("conditions", 64, 3, True),   # hd = 16; weights from the flat form
])
def test_variant_encoders_heads_fusion_match_jax(enc_type, task, d, layers,
                                                 flat):
    _check_models_match_jax(*both(task, d, layers, seed=1, enc_type=enc_type,
                                  flat=flat), VARIANT_TOL)


def _check_models_match_jax(spec, jcfg, tcfg, jm, tm, tol):
    rng = np.random.default_rng(2)
    xa = rng.standard_normal((5, spec.seq_a, spec.feat_a)).astype(np.float32)
    xb = rng.standard_normal((5, spec.seq_b, spec.feat_b)).astype(np.float32)
    ta, tb = torch.from_numpy(xa), torch.from_numpy(xb)

    ha_j = jenc.encoder_apply(jm["f_A"], jnp.asarray(xa), jcfg)
    hb_j = jenc.encoder_apply(jm["f_B"], jnp.asarray(xb), jcfg)
    ha_t = tenc.encoder_apply(tm["f_A"], ta, tcfg)
    hb_t = tenc.encoder_apply(tm["f_B"], tb, tcfg)
    np.testing.assert_allclose(ha_t.numpy(), np.asarray(ha_j), **tol)
    np.testing.assert_allclose(hb_t.numpy(), np.asarray(hb_j), **tol)

    np.testing.assert_allclose(
        tenc.fusion_apply(tm["g_M"], ha_t, hb_t).numpy(),
        np.asarray(jenc.fusion_apply(jm["g_M"], ha_j, hb_j)), **tol)
    for mod, x, xj in (("A", ta, xa), ("B", tb, xb)):
        got = tenc.predict_unimodal(tm, x, mod, tcfg)
        want = jenc.predict_unimodal(jm, jnp.asarray(xj), mod, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    logits_t = tenc.predict_multimodal(tm, ta, tb, tcfg)
    logits_j = jenc.predict_multimodal(jm, jnp.asarray(xa), jnp.asarray(xb), jcfg)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **tol)
    for kind in ("multiclass", "multilabel", "binary"):
        np.testing.assert_allclose(
            tenc.task_scores(logits_t, kind).numpy(),
            np.asarray(jenc.task_scores(logits_j, kind)), **tol)


def test_common_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 24)).astype(np.float32)
    p = {"w": rng.standard_normal((24, 9)).astype(np.float32),
         "b": rng.standard_normal(9).astype(np.float32)}
    g = {"g": rng.uniform(0.5, 1.5, 24).astype(np.float32)}
    np.testing.assert_allclose(
        tcommon.dense(params_from_numpy(p, "cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x))),
        **TOL)
    np.testing.assert_allclose(
        tcommon.rmsnorm(params_from_numpy(g, "cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.rmsnorm(jax.tree.map(jnp.asarray, g), jnp.asarray(x))),
        **TOL)
    # bf16 input: computed in f32, cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = tcommon.rmsnorm(params_from_numpy(g, "cpu"), xb)
    assert out.dtype == torch.bfloat16


def test_init_shapes_and_scale_match_reference():
    spec = jax_make_task("conditions")
    jcfg = jenc.EncoderConfig(d_hidden=48, n_layers=2)
    tcfg = tenc.EncoderConfig(d_hidden=48, n_layers=2)
    want = jax.tree.map(lambda x: x.shape, jenc.init_client_models(
        jax.random.PRNGKey(0), spec, jcfg))
    gen = torch.Generator().manual_seed(0)
    got = tenc.init_client_models(gen, make_task("conditions"), tcfg,
                                  device="cpu")
    assert jax.tree.map(lambda x: x.shape, params_to_numpy(got)) == want
    assert not got["f_A"]["in"]["b"].any()
    assert (got["f_A"]["norm"]["g"] == 1).all()
    big = tcommon.dense_init(torch.Generator().manual_seed(1), 400, 300,
                             torch.float32, device="cpu")["w"]
    assert abs(float(big.std()) * np.sqrt(400) - 1.0) < 0.02
    # one seed gives the same weights whichever device they land on
    again = tenc.init_client_models(torch.Generator().manual_seed(0),
                                    make_task("conditions"), tcfg, device="cpu")
    assert torch.equal(again["g_M"]["mix"]["w"], got["g_M"]["mix"]["w"])


def test_convert_roundtrip_nested_and_flat():
    spec = jax_make_task("smnist")
    np_models = noisy_numpy_models(spec, jenc.EncoderConfig(d_hidden=16,
                                                            n_layers=2), 4)
    nested = params_from_numpy(np_models, "cpu")
    back = params_to_numpy(nested)
    assert isinstance(back["f_A"]["hidden"], list)
    jax.tree.map(np.testing.assert_array_equal, back, np_models)
    # flat /-keyed form, as a checkpoint's arrays.npz stores it
    flat = flat_keys(np_models)
    assert "f_A/hidden/1/w" in flat
    from_flat = params_to_numpy(params_from_numpy(flat, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, from_flat, np_models)
    # leaves are copies: mutating the numpy tree leaves the port alone
    np_models["g_A"]["b"][:] = 99.0
    assert not (nested["g_A"]["b"] == 99.0).any()


@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
def test_variant_init_shapes_match_reference(enc_type):
    spec = jax_make_task("conditions")
    for layers in (1, 3):
        jcfg = jenc.EncoderConfig(d_hidden=48, n_layers=layers, enc_type=enc_type)
        tcfg = tenc.EncoderConfig(d_hidden=48, n_layers=layers, enc_type=enc_type)
        want = jax.tree.map(lambda x: x.shape, jenc.init_client_models(
            jax.random.PRNGKey(0), spec, jcfg))
        got = tenc.init_client_models(torch.Generator().manual_seed(0),
                                      make_task("conditions"), tcfg,
                                      device="cpu")
        assert jax.tree.map(lambda x: x.shape, params_to_numpy(got)) == want
        enc = got["f_A"]
        if enc_type == "recurrent":
            assert not enc["cell"]["b"].any()
            assert abs(float(enc["cell"]["wx"].std()) * np.sqrt(48) - 1) < 0.05
        else:
            assert (enc["ln"]["g"] == 1).all() and not enc["ff"]["b"].any()
            assert "b" not in enc["wq"]


@pytest.mark.parametrize("enc_type,keys", [
    ("recurrent", ("f_A/cell/wx", "f_A/cell/r", "f_A/cell/b")),
    ("transformer", ("f_A/ln/g", "f_A/wq/w", "f_A/wk/w", "f_A/wv/w",
                     "f_A/ff/w", "f_A/ff/b")),
])
def test_variant_convert_roundtrip_nested_and_flat(enc_type, keys):
    spec = jax_make_task("smnist")
    np_models = noisy_numpy_models(spec, jenc.EncoderConfig(
        d_hidden=16, n_layers=1, enc_type=enc_type), 4)
    back = params_to_numpy(params_from_numpy(np_models, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, np_models)
    flat = flat_keys(np_models)
    assert set(keys) <= set(flat)
    from_flat = params_to_numpy(params_from_numpy(flat, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, from_flat, np_models)


def test_reference_transformer_init_reuses_keys_port_does_not():
    """ROADMAP.md §3: the reference's ``encoder_init`` splits
    ``n_layers + 2`` keys but its transformer branch reads ``ks[1..4]``;
    JAX clamps the indices past the end, so with one layer its wk, wv and
    ff.w are one draw, and with two its ff.w is wv. The port draws
    independent weights; parity tests carry the reference's over."""
    def ref(layers):
        cfg = jenc.EncoderConfig(d_hidden=16, n_layers=layers,
                                 enc_type="transformer")
        return jax.tree.map(np.asarray, jenc.encoder_init(
            jax.random.PRNGKey(0), 8, cfg))

    one, two = ref(1), ref(2)
    assert np.array_equal(one["wk"]["w"], one["wv"]["w"])
    assert np.array_equal(one["wv"]["w"], one["ff"]["w"])
    assert np.array_equal(two["ff"]["w"], two["wv"]["w"])
    assert not np.array_equal(two["wk"]["w"], two["wv"]["w"])
    port = tenc.encoder_init(torch.Generator().manual_seed(0), 8,
                             tenc.EncoderConfig(d_hidden=16, n_layers=1,
                                                enc_type="transformer"),
                             device="cpu")
    ws = [port[k]["w"] for k in ("wq", "wk", "wv", "ff")]
    assert all(not torch.equal(a, b) for i, a in enumerate(ws) for b in ws[i + 1:])


def test_unknown_encoder_type_raises():
    cfg = tenc.EncoderConfig(d_hidden=16, n_layers=1, enc_type="conv")
    with pytest.raises(ValueError, match="conv"):
        tenc.encoder_init(torch.Generator(), 8, cfg, device="cpu")
    with pytest.raises(ValueError, match="conv"):
        tenc.encoder_apply({}, torch.zeros(2, 3, 8), cfg)
