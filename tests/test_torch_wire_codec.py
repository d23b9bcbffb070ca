"""Wire codec of the PyTorch port against the JAX reference, on the CPU.

The port's plain version (``repro_torch.kernels.wire_codec.ref``) is
held against ``repro.kernels.wire_codec.ref`` on shared [scale, thresh]
inputs, and the port's public wrapper on a CPU tensor against the JAX
wrapper, which runs the Pallas kernel in interpret mode off-TPU.

Tolerance: keep-masks and int8 codes identical; decoded values within
4 * eps_f32 * scale_row (the JAX interpret kernel and its own ref drift
by up to that much in the dequant q * (s/127)); the dense identity
exact. bf16 outputs are compared at one bf16 ulp of the row's scale on
top of that, since an f32 drift of a few ulp can cross a bf16 rounding
boundary.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wire_codec.ops import wire_codec_roundtrip as jax_roundtrip
from repro.kernels.wire_codec.ref import wire_codec_ref as jax_ref
from repro_torch.kernels.wire_codec.ops import scale_thresh, wire_codec_roundtrip
from repro_torch.kernels.wire_codec.ref import wire_codec_ref

EPS32 = float(np.finfo(np.float32).eps)
BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def _rows(l, n, seed, *, zero_row=False, ties=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((l, n))
         * rng.uniform(0.1, 10.0, (l, 1))).astype(np.float32)
    if zero_row:
        x[0] = 0.0
    if ties:  # many entries share the threshold magnitude, both signs
        x[-1, : n // 2] = np.where(np.arange(n // 2) % 2, 0.5, -0.5)
        x[-1, n // 2:] = rng.uniform(-0.4, 0.4, n - n // 2)
    return x


def _np_scale_thresh(x, k):
    ax = np.abs(x.astype(np.float32))
    scale = np.maximum(ax.max(axis=1), 1e-30)
    if k is None or k >= x.shape[1]:
        thresh = np.zeros_like(scale)
    else:
        thresh = -np.sort(-ax, axis=1)[:, k - 1]
    return np.stack([scale, thresh], axis=1).astype(np.float32)


def assert_codec_close(got, want, scale, quantize, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got != 0, want != 0)  # keep-masks
    if not quantize:
        np.testing.assert_array_equal(got, want)
        return
    scale = scale[:, None]
    tol = 4 * EPS32 * scale + (BF16_ULP * scale if bf16 else 0.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    if not bf16:  # int8 codes
        np.testing.assert_array_equal(np.rint(got * 127 / scale),
                                      np.rint(want * 127 / scale))


@pytest.mark.parametrize("l,n,frac,quantize", [
    (1, 64, 0.25, False),
    (3, 333, 0.25, True),     # ragged N
    (5, 2048, None, True),    # dense int8 (thresh 0)
    (2, 100, 0.01, False),    # k=1 extreme sparsity
    (4, 512, 1.0, True),      # keep-all + quantize
    (6, 1024, 0.25, True),    # serving feature rows, k=256
    (6, 25, 0.25, True),      # serving score rows, k=7
])
def test_ref_matches_jax_ref(l, n, frac, quantize):
    x = _rows(l, n, seed=n + l)
    k = None if frac is None else max(1, int(np.ceil(frac * n)))
    st = _np_scale_thresh(x, k)
    got = wire_codec_ref(torch.from_numpy(x), torch.from_numpy(st),
                         quantize=quantize)
    want = jax_ref(jnp.asarray(x), jnp.asarray(st), quantize=quantize)
    assert_codec_close(got.numpy(), want, st[:, 0], quantize)


@pytest.mark.parametrize("case", ["ragged", "identity", "zero_row", "ties",
                                  "serving_feat", "serving_scores"])
@pytest.mark.parametrize("quantize", [False, True])
def test_roundtrip_matches_jax_interpret(case, quantize):
    l, n, k, kw = {
        "ragged": (5, 4097, 1025, {}),
        "identity": (3, 300, 300, {}),
        "zero_row": (4, 256, 64, {"zero_row": True}),
        "ties": (3, 128, 32, {"ties": True}),
        "serving_feat": (4, 1024, 256, {}),
        "serving_scores": (16, 25, 7, {}),
    }[case]
    x = _rows(l, n, seed=7, **kw)
    got = wire_codec_roundtrip(torch.from_numpy(x), k=k, quantize=quantize)
    want = jax_roundtrip(jnp.asarray(x), k=k, quantize=quantize)
    assert_codec_close(got.numpy(), want, _np_scale_thresh(x, k)[:, 0],
                       quantize)
    if case == "identity" and not quantize:
        np.testing.assert_array_equal(got.numpy(), x)
    if case == "zero_row":
        assert not got.numpy()[0].any()
    if case == "ties":  # every entry tied at the threshold is kept
        assert (got.numpy()[-1, : n // 2] != 0).all()


@pytest.mark.parametrize("quantize", [False, True])
def test_roundtrip_bf16_matches_jax(quantize):
    x = _rows(3, 777, seed=11)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    got = wire_codec_roundtrip(xt, k=200, quantize=quantize)
    want = jax_roundtrip(xj, k=200, quantize=quantize)
    assert got.dtype == torch.bfloat16
    scale = np.abs(xt.float().numpy()).max(axis=1)
    assert_codec_close(got.float().numpy(), np.asarray(want, np.float32),
                       scale, quantize, bf16=True)


def test_scale_thresh_matches_numpy():
    x = _rows(4, 300, seed=3, zero_row=True)
    for k in (None, 1, 75, 300):
        np.testing.assert_array_equal(
            scale_thresh(torch.from_numpy(x), k).numpy(),
            _np_scale_thresh(x, k))


def test_dense_identity_is_exact():
    x = _rows(3, 129, seed=5)
    x[1, :3] = [-0.0, 0.0, 1e-38]
    got = wire_codec_roundtrip(torch.from_numpy(x), k=None, quantize=False)
    assert np.array_equal(got.numpy().view(np.uint32), x.view(np.uint32))


def _codec_trees(seed):
    """(trained, base, resid) stacked trees of 3 clients, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 40, 6), "b": (3, 6), "big": (3, 70000)}
    base = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    trained = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in base.items()}
    resid = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in base.items()}
    return trained, base, resid


@pytest.mark.parametrize("name", ["int8", "topk", "int8_topk"])
def test_training_roundtrips_match_jax(name):
    """Error-feedback uplink (stacked rows) and downlink (one tree) of the
    training round against the reference: the same deltas go through
    the same codec, so decoded trees and residuals agree within the
    kernel's dequant drift (values here are below 1, so 1e-5 covers
    4 * eps32 * scale many times over)."""
    from repro.core import codec as jcodec
    from repro_torch.core import codec as tcodec

    trained, base, resid = _codec_trees(3)
    jt = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    tt = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    jcfg, tcfg = jcodec.make_codec(name, 0.25), tcodec.make_codec(name, 0.25)
    outs = [(jcodec.uplink_roundtrip(jt(trained), jt(base), jt(resid), jcfg),
             tcodec.uplink_roundtrip(tt(trained), tt(base), tt(resid), tcfg))]
    one = {k: v[0] for k, v in trained.items()}
    prev = {k: v[1] for k, v in base.items()}
    res1 = {k: v[2] for k, v in resid.items()}
    outs.append((jcodec.downlink_roundtrip(jt(one), jt(prev), jt(res1), jcfg),
                 tcodec.downlink_roundtrip(tt(one), tt(prev), tt(res1), tcfg)))
    for (jdec, jres), (tdec, tres) in outs:
        for k in jdec:
            np.testing.assert_allclose(tdec[k].numpy(), np.asarray(jdec[k]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                       rtol=0, atol=1e-5)


def test_training_identity_codec_is_exact_and_bytes_match_jax():
    """topk at frac 1.0 is the identity: the uplink hands back the trained
    tree bit for bit and leaves the residual at zero; and the analytic
    round bytes equal the reference's for every codec."""
    from repro.core import codec as jcodec
    from repro_torch.core import codec as tcodec

    trained, base, _ = _codec_trees(4)
    tt = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    zeros = tcodec.zeros_like_tree(tt(trained))
    dec, res = tcodec.uplink_roundtrip(tt(trained), tt(base), zeros,
                                       tcodec.make_codec("topk", 1.0))
    for k in trained:
        assert torch.equal(dec[k], torch.from_numpy(trained[k]))
        assert not bool(res[k].any())
    template = {k: v[0] for k, v in trained.items()}
    for name in ("none", "int8", "topk", "int8_topk"):
        want = jcodec.round_bytes(template, jcodec.make_codec(name, 0.25), 3, 3)
        got = tcodec.round_bytes(tt(template), tcodec.make_codec(name, 0.25), 3, 3)
        assert got == want
