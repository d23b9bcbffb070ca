"""sLSTM cell of the PyTorch port against the JAX reference, on the CPU:
the kernel's plain version (from the zero state and from a given state),
the ``slstm_scan`` / ``slstm_step`` layer over it, its initialiser, and
the wrapper's routing.

The plain version is held against the reference's ``slstm_cell_ref`` and
its Pallas kernel in interpret mode, at the shapes ``tests/test_kernels.py``
uses, within atol 2e-5 / rtol 2e-4 (the reference's kernel-test
tolerance: f32 sums in another order, carried through S steps); a bf16
input within 2e-2. The port's ``slstm_scan`` against the reference's
``slstm_scan`` (outputs and final state, from the zero state or a given
one) and ``slstm_step`` within atol 1e-5 / rtol 1e-4; a prompt run in
two halves, the second from the first's final state, equals one whole
pass within the same tolerance. The CUDA kernel itself runs only on the
card (``tests/test_torch_cuda.py``).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_cell.ref import slstm_cell_ref as jax_ref
from repro.kernels.slstm_cell.slstm_cell import slstm_cell_pallas
from repro.models import recurrent as jrec
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.slstm_cell import slstm_cell as launcher
from repro_torch.kernels.slstm_cell.ops import slstm_cell
from repro_torch.kernels.slstm_cell.ref import slstm_cell_ref, slstm_error_bound
from repro_torch.models import recurrent as trec


def _inputs(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((b, h, s, 4, hd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((h, hd, 4 * hd)) / np.sqrt(hd)).astype(np.float32)
    return pre, r


@pytest.mark.parametrize("b,h,s,hd,chunk", [
    (1, 2, 32, 16, 16),
    (2, 4, 50, 8, 32),    # ragged length (the TPU kernel's padding path)
    (1, 1, 64, 32, 64),   # single chunk
])
def test_plain_version_matches_jax_ref_and_interpret_kernel(b, h, s, hd, chunk):
    pre, r = _inputs(b, h, s, hd, seed=s + hd)
    got = slstm_cell(torch.from_numpy(pre), torch.from_numpy(r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, s, hd)
    for want in (jax_ref(jnp.asarray(pre), jnp.asarray(r)),
                 slstm_cell_pallas(jnp.asarray(pre), jnp.asarray(r),
                                   chunk=chunk, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-4)


def test_plain_version_bf16_matches_jax_ref():
    pre, r = _inputs(2, 4, 50, 8, seed=7)
    got = slstm_cell(torch.from_numpy(pre).bfloat16(), torch.from_numpy(r))
    want = jax_ref(jnp.asarray(pre, jnp.bfloat16), jnp.asarray(r))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("d,n_heads,s", [(32, 4, 12), (256, 4, 64)])
def test_slstm_scan_matches_jax(d, n_heads, s):
    p = jrec.slstm_init(jax.random.PRNGKey(0), d, n_heads, jnp.float32)
    rng = np.random.default_rng(d)
    np_p = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), p)  # the zero bias gets noise too
    x = rng.standard_normal((3, s, d)).astype(np.float32)
    want, want_fin = jrec.slstm_scan(jax.tree.map(jnp.asarray, np_p),
                                     jnp.asarray(x), n_heads)
    got, got_fin = trec.slstm_scan(params_from_numpy(np_p, "cpu"),
                                   torch.from_numpy(x), n_heads)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    for g, w in zip(got_fin, want_fin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_slstm_scan_has_no_state_arguments():
    """The scan takes the decode state as the reference does (and
    ``return_state``, False where a gradient is wanted), but not the
    reference's batch sharding (``shard_axes``), which the port does not
    run: it does not take it rather than ignore it."""
    assert list(inspect.signature(trec.slstm_scan).parameters) == [
        "p", "x", "n_heads", "initial_state", "return_state"]
    with pytest.raises(TypeError):
        trec.slstm_scan({}, torch.zeros(1, 2, 8), 2, shard_axes=())


def _state(b, h, hd, seed):
    """A non-zero (c, n, m, h), as a running sequence leaves it."""
    rng = np.random.default_rng(seed)
    c, n, m, hp = (rng.standard_normal((b, h, hd)).astype(np.float32)
                   for _ in range(4))
    return c, np.abs(n) + 1.0, 0.5 * m, np.tanh(hp)


@pytest.mark.parametrize("b,h,s,hd", [(2, 4, 50, 8), (1, 2, 1, 16)])
def test_plain_version_from_a_state_matches_jax(b, h, s, hd):
    """The plain version from a given state against the reference's
    slstm_scan(initial_state=...) on the same pre-activations (x @ wx,
    formed in numpy and laid out per head): outputs and final state."""
    d = h * hd
    rng = np.random.default_rng(s + hd)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    wx = (rng.standard_normal((d, 4 * d)) / np.sqrt(d)).astype(np.float32)
    _, r = _inputs(b, h, s, hd, seed=s + 3)
    st = _state(b, h, hd, seed=hd)
    pre = (x @ wx).reshape(b, s, 4, h, hd).transpose(0, 3, 1, 2, 4)
    got, fin = slstm_cell(torch.from_numpy(np.ascontiguousarray(pre)),
                          torch.from_numpy(r),
                          tuple(torch.from_numpy(a) for a in st),
                          return_state=True)
    p = {"wx": jnp.asarray(wx), "r": jnp.asarray(r),
         "b": jnp.zeros((4 * d,), jnp.float32)}
    want, want_fin = jrec.slstm_scan(p, jnp.asarray(x), h,
                                     initial_state=tuple(map(jnp.asarray, st)))
    want = np.asarray(want).reshape(b, s, h, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    for g, w in zip(fin, want_fin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_slstm_step_matches_jax():
    d, n_heads, b = 64, 4, 3
    p = jrec.slstm_init(jax.random.PRNGKey(2), d, n_heads, jnp.float32)
    rng = np.random.default_rng(5)
    np_p = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), p)
    x = rng.standard_normal((b, d)).astype(np.float32)
    st = _state(b, n_heads, d // n_heads, seed=1)
    want, want_fin = jrec.slstm_step(jax.tree.map(jnp.asarray, np_p),
                                     jnp.asarray(x), n_heads,
                                     tuple(map(jnp.asarray, st)))
    got, got_fin = trec.slstm_step(params_from_numpy(np_p, "cpu"),
                                   torch.from_numpy(x), n_heads,
                                   tuple(torch.from_numpy(a) for a in st))
    assert tuple(got.shape) == (b, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    for g, w in zip(got_fin, want_fin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def test_prefill_in_two_halves_equals_one_pass():
    """The second half from the first half's final state gives the same
    outputs and final state as one pass over the whole prompt."""
    d, n_heads = 32, 4
    p = trec.slstm_init(torch.Generator().manual_seed(3), d, n_heads,
                        torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 20, d)).astype(np.float32))
    whole, fin = trec.slstm_scan(p, x, n_heads)
    first, mid = trec.slstm_scan(p, x[:, :7], n_heads)
    second, fin2 = trec.slstm_scan(p, x[:, 7:], n_heads, initial_state=mid)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), atol=1e-5, rtol=1e-4)
    for a, b in zip(fin2, fin):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_init_shapes_and_scales_match_reference():
    d, n_heads = 64, 4
    want = jrec.slstm_init(jax.random.PRNGKey(0), d, n_heads, jnp.float32)
    got = trec.slstm_init(torch.Generator().manual_seed(0), d, n_heads,
                          torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not got["b"].any()
    big = trec.slstm_init(torch.Generator().manual_seed(1), 256, 4,
                          torch.float32, device="cpu")
    assert abs(float(big["wx"].std()) * np.sqrt(256) - 1.0) < 0.02
    assert abs(float(big["r"].std()) * np.sqrt(64) - 1.0) < 0.02


def test_error_bound_adds_a_bf16_ulp():
    want = torch.tensor([1.0, 0.0, -3.0]).bfloat16()
    got = torch.tensor([1.0078125, 0.0, -3.0]).bfloat16()  # one ulp at 1
    bound = slstm_error_bound(want, got)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    f32 = slstm_error_bound(torch.tensor([2.0]), torch.tensor([2.0]))
    assert float(f32[0]) == pytest.approx(1e-5 + 2e-4)


def test_wrapper_refuses_other_devices():
    pre, r = _inputs(1, 1, 2, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        slstm_cell(torch.from_numpy(pre).to("meta"), torch.from_numpy(r))


@pytest.mark.parametrize("pre,r,match", [
    (torch.ones(1, 1, 2, 4, 8, dtype=torch.float64), torch.ones(1, 8, 32),
     "float32 or bfloat16"),
    (torch.ones(1, 1, 2, 4, 8), torch.ones(1, 8, 32, dtype=torch.bfloat16),
     "one dtype"),
    (torch.ones(1, 1, 2, 3, 8), torch.ones(1, 8, 32), "want pre_x"),
    (torch.ones(1, 1, 2, 4, 8), torch.ones(1, 8, 24), "want r"),
    (torch.ones(1, 2, 2, 4, 8).transpose(1, 2), torch.ones(2, 8, 32),
     "contiguous"),
    (torch.ones(1, 1, 2, 4, 264), torch.ones(1, 264, 1056), "at most 256"),
    (torch.ones(1, 1, 2, 4, 8), torch.ones(1, 8, 32), "CUDA"),
])
def test_cuda_launcher_refuses_before_launching(pre, r, match):
    """No silent fallback and no bad launch: the launcher raises on what
    the kernel does not take (a CPU tensor included) before it builds or
    launches anything."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.slstm_cell_cuda(pre, r)
    assert launcher.launches == before


@pytest.mark.parametrize("state,match", [
    ((torch.zeros(1, 1, 8),) * 3, "want the state"),
    ((torch.zeros(1, 1, 8, dtype=torch.float64),) * 4, "float32"),
    ((torch.zeros(1, 1, 4),) * 4, "float32, contiguous"),
])
def test_cuda_launcher_refuses_a_bad_state(state, match):
    pre = torch.ones(1, 1, 2, 4, 8).to("meta")
    r = torch.ones(1, 8, 32).to("meta")
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.slstm_cell_cuda(pre, r, initial_state=state)
    assert launcher.launches == before
