"""BlendAvg (Eq. 9-11) of the PyTorch port against the JAX reference, on
the CPU: the blend kernel's plain version, its tree wrapper, and
``core/blendavg.py``.

The plain version is held against the reference's ``blend_params_ref``
and its Pallas kernel in interpret mode, at the shapes
``tests/test_kernels.py`` uses. Tolerances: f32 1e-6 (f32 sums of L
products in different orders), bf16 2e-2 (the result is rounded to bf16,
and the two sums may land on either side of a rounding boundary).
``blendavg_weights`` is a numpy float64 copy, so it is compared bit for
bit. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.blendavg.blendavg import blend_params_pallas
from repro.kernels.blendavg.ops import blend_params as jax_blend_params
from repro.kernels.blendavg.ref import blend_params_ref as jax_ref
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import blendavg as tba
from repro_torch.kernels.blendavg import blendavg as launcher
from repro_torch.kernels.blendavg.ops import blend_params
from repro_torch.kernels.blendavg.ref import blend_params_ref

# the module, not the ``blendavg`` function that ``repro.core`` exports
jba = importlib.import_module("repro.core.blendavg")

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(l, n, seed):
    rng = np.random.default_rng(seed)
    stacked = rng.standard_normal((l, n)).astype(np.float32)
    e = np.exp(rng.standard_normal(l))
    return stacked, (e / e.sum()).astype(np.float32)


@pytest.mark.parametrize("l,n,block", [(3, 1000, 256), (5, 2048, 2048),
                                       (2, 33, 16), (7, 4097, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_ref_and_interpret_kernel(l, n, block, dtype):
    stacked, omega = _inputs(l, n, seed=l * n)
    js = jnp.asarray(stacked, getattr(jnp, dtype))
    ts = torch.from_numpy(stacked).to(getattr(torch, dtype))
    got = blend_params(ts, torch.from_numpy(omega))  # CPU: the plain version
    assert got.dtype == ts.dtype and tuple(got.shape) == (n,)
    got = got.float().numpy()
    for want in (jax_ref(js, jnp.asarray(omega)),
                 blend_params_pallas(js, jnp.asarray(omega), block_n=block,
                                     interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_zero_omega_drops_models():
    """omega=0 rows must not contribute (discarded models, Eq. 10)."""
    stacked = torch.stack([torch.ones(64), 100.0 * torch.ones(64),
                           3.0 * torch.ones(64)])
    out = blend_params_ref(stacked, torch.tensor([0.5, 0.0, 0.5]))
    np.testing.assert_allclose(out.numpy(), 2.0 * np.ones(64), rtol=1e-6)


def _model_tree(l, seed):
    rng = np.random.default_rng(seed)
    return {"in": {"w": rng.standard_normal((l, 6, 4)).astype(np.float32),
                   "b": rng.standard_normal((l, 4)).astype(np.float32)},
            "hidden": [{"w": rng.standard_normal((l, 4, 4)).astype(np.float32)}],
            "norm": {"g": rng.standard_normal((l, 4)).astype(np.float32)}}


def test_tree_wrapper_matches_jax():
    tree = _model_tree(4, seed=0)
    omega = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    want = jax_blend_params(jax.tree.map(jnp.asarray, tree), jnp.asarray(omega))
    got = blend_params(params_from_numpy(tree, "cpu"), torch.from_numpy(omega))
    assert got["in"]["w"].shape == (6, 4) and isinstance(got["hidden"], list)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                         rtol=1e-6, atol=1e-6),
                 want, params_to_numpy(got))


@pytest.mark.parametrize("scores,glob,staleness", [
    ([0.7, 0.5, 0.9], 0.6, None),
    ([0.1, 0.2], 0.5, None),                       # all worse: zero vector
    ([float("nan"), 0.9, 0.61], 0.6, None),        # NaN candidate masked
    ([0.9, 0.9, 0.1], 0.5, [0, 8, 0]),             # staleness damping
    ([0.8, float("-inf"), 0.7], 0.65, [2, 0, 1]),  # unfinished candidate
    ([0.6], 0.6, None),                            # a tie is no improvement
])
def test_blendavg_weights_bit_for_bit(scores, glob, staleness):
    want = jba.blendavg_weights(scores, glob, staleness=staleness,
                                staleness_exp=0.5)
    got = tba.blendavg_weights(scores, glob, staleness=staleness,
                               staleness_exp=0.5)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [float("nan"), float("-inf"), float("inf")])
def test_nonfinite_global_score_raises(bad):
    with pytest.raises(ValueError, match="global_score"):
        tba.blendavg_weights([0.7, 0.9], global_score=bad)


def test_blendavg_keeps_global_and_blends_like_jax():
    glob = {"w": torch.ones(8)}
    cands = [{"w": torch.zeros(8)}, {"w": 2 * torch.ones(8)}]
    scores = {id(cands[0]): 0.1, id(cands[1]): 0.2}
    blended, info = tba.blendavg(glob, cands, lambda m: scores.get(id(m), 0.9))
    assert info["kept_global"] and blended is glob

    rng = np.random.default_rng(7)
    np_cands = [{"w": rng.standard_normal(16).astype(np.float32)} for _ in range(3)]
    ev = [0.5, 0.6, 0.45, 0.8]  # global, then the candidates
    jglob = {"w": jnp.zeros(16)}
    jc = [jax.tree.map(jnp.asarray, c) for c in np_cands]
    jscore = {id(jglob): ev[0], **{id(c): s for c, s in zip(jc, ev[1:])}}
    want, jinfo = jba.blendavg(jglob, jc, lambda m: jscore[id(m)])
    tglob = {"w": torch.zeros(16)}
    tc = [params_from_numpy(c, "cpu") for c in np_cands]
    tscore = {id(tglob): ev[0], **{id(c): s for c, s in zip(tc, ev[1:])}}
    got, tinfo = tba.blendavg(tglob, tc, lambda m: tscore[id(m)])
    assert not tinfo["kept_global"]
    np.testing.assert_array_equal(tinfo["omega"], jinfo["omega"])
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-6)


def test_fedavg_weights_and_zero_volume_raise():
    rng = np.random.default_rng(8)
    np_cands = [{"w": rng.standard_normal(12).astype(np.float32)} for _ in range(3)]
    for n_samples in ([3, 1, 0], None):
        want = jba.fedavg([jax.tree.map(jnp.asarray, c) for c in np_cands],
                          n_samples=n_samples)
        got = tba.fedavg([params_from_numpy(c, "cpu") for c in np_cands],
                         n_samples=n_samples)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="zero"):
        tba.fedavg([params_from_numpy(c, "cpu") for c in np_cands],
                   n_samples=[0, 0, 0])


def test_omega_reaches_the_blend_as_f32():
    """The reference rounds float64 omegas to f32 before blending
    (``jnp.asarray(omega, jnp.float32)``); the port does the same, so a
    weight that float64 would keep distinct blends like its f32 value."""
    omega = np.array([1 / 3, 2 / 3], np.float64)
    cands = [{"w": torch.full((4,), 3.0)}, {"w": torch.full((4,), 6.0)}]
    got = tba.blend_trees(cands, omega)["w"]
    f32 = omega.astype(np.float32)
    want = np.float32(np.float32(f32[0] * np.float32(3.0))
                      + np.float32(f32[1] * np.float32(6.0)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.full(4, want, np.float32))


@pytest.mark.parametrize("stacked,omega,match", [
    (torch.ones(2, 8, dtype=torch.float64), torch.ones(2), "float32 or bfloat16"),
    (torch.ones(2, 8), torch.ones(2, dtype=torch.float64), "omega must be float32"),
    (torch.ones(2, 8), torch.ones(3), "want stacked"),
    (torch.ones(8, 2).t(), torch.ones(2), "contiguous"),
    (torch.ones(257, 8), torch.ones(257), "rows"),
    (torch.ones(2, 8), torch.ones(2), "CUDA"),
])
def test_cuda_launcher_refuses_before_launching(stacked, omega, match):
    """No silent fallback and no bad launch: the launcher raises on what
    the kernel does not take (a CPU tensor included) before it builds or
    launches anything."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.blend_params_cuda(stacked, omega)
    assert launcher.launches == before
