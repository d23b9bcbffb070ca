"""mLSTM scan of the PyTorch port against the JAX reference, on the CPU:
the kernel's plain version, ``gated_linear_scan`` / ``gated_linear_step``
over it, and the wrapper's and launcher's routing and checks.

The plain version (the step recurrence) is held against the reference's
``mlstm_scan_ref`` and its Pallas kernel in interpret mode at the shapes
``tests/test_kernels.py`` uses, normalize on and off, within atol 1e-5 /
rtol 1e-4 (f32 sums in another order, carried through S steps; the
interpret kernel's chunkwise sums differ from the step recurrence by up
to about 1e-4 of the larger outputs, so it gets the reference's own
kernel-test tolerance, atol 5e-4 / rtol 5e-3). The final (C, n) against
the reference's ``gated_linear_scan(return_state=True)`` within atol
1e-5 / rtol 1e-4, at an S that is not a multiple of the chunk. The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan.mlstm_scan import mlstm_scan_pallas
from repro.kernels.mlstm_scan.ref import mlstm_scan_ref as jax_ref
from repro.models import recurrent as jrec
from repro_torch.kernels.mlstm_scan import mlstm_scan as launcher
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_error_bound, mlstm_scan_ref
from repro_torch.models import recurrent as trec


def _inputs(b, h, s, dk, dv, seed):
    """The reference kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dk)).astype(np.float32)
    k = (rng.standard_normal((b, h, s, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    lf = (-np.abs(rng.standard_normal((b, h, s))) * 0.2).astype(np.float32)
    return q, k, v, lf


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


SHAPES = [(1, 2, 64, 16, 16, 16), (2, 3, 100, 32, 16, 32),  # ragged length
          (1, 1, 128, 64, 64, 128)]  # single chunk


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_version_matches_jax_ref_and_interpret_kernel(b, h, s, dk, dv,
                                                            chunk, normalize):
    q, k, v, lf = _inputs(b, h, s, dk, dv, seed=s + dk)
    got = mlstm_scan(*_t(q, k, v, lf), chunk=chunk, normalize=normalize)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, s, dv)
    jq, jk, jv, jlf = map(jnp.asarray, (q, k, v, lf))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref(jq, jk, jv, jlf, normalize=normalize)), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(mlstm_scan_pallas(
        jq, jk, jv, jlf, chunk=chunk, normalize=normalize, interpret=True)),
        atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("s,chunk", [(100, 32), (12, 64), (64, 64)])
def test_final_state_matches_jax_gated_linear_scan(s, chunk):
    """h and the final (C, n), with S not a multiple of the chunk: the
    padded steps must leave the state of the real S steps."""
    q, k, v, lf = _inputs(2, 3, s, 32, 24, seed=s)
    got, (c, n) = trec.gated_linear_scan(*_t(q, k, v, lf), chunk=chunk,
                                         return_state=True)
    want, (wc, wn) = jrec.gated_linear_scan(*map(jnp.asarray, (q, k, v, lf)),
                                            chunk=chunk, return_state=True)
    for g, w in ((got, want), (c, wc), (n, wn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
    assert tuple(c.shape) == (2, 3, 32, 24) and tuple(n.shape) == (2, 3, 32)


def test_step_and_ref_match_jax():
    q, k, v, lf = _inputs(2, 2, 9, 16, 8, seed=3)
    state = (np.random.default_rng(4).standard_normal((2, 2, 16, 8)).astype(np.float32),
             np.abs(np.random.default_rng(5).standard_normal((2, 2, 16))).astype(np.float32))
    h, (c, n) = trec.gated_linear_step(*_t(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                           lf[:, :, 0]), tuple(_t(*state)))
    wh, (wc, wn) = jrec.gated_linear_step(
        *map(jnp.asarray, (q[:, :, 0], k[:, :, 0], v[:, :, 0], lf[:, :, 0])),
        tuple(map(jnp.asarray, state)))
    for g, w in ((h, wh), (c, wc), (n, wn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(
        trec.gated_linear_scan_ref(*_t(q, k, v, lf)).numpy(),
        np.asarray(jrec.gated_linear_scan_ref(*map(jnp.asarray, (q, k, v, lf)))),
        atol=1e-5, rtol=1e-4)


def test_scan_then_steps_equal_one_scan():
    """Decode continues a prefill: steps from the scan's final state give
    what one longer scan gives."""
    q, k, v, lf = _inputs(1, 2, 20, 16, 16, seed=7)
    whole = trec.gated_linear_scan(*_t(q, k, v, lf), chunk=16)
    head, state = trec.gated_linear_scan(*_t(q[:, :, :15], k[:, :, :15],
                                             v[:, :, :15], lf[:, :, :15]),
                                         chunk=16, return_state=True)
    steps = []
    for t in range(15, 20):
        ht, state = trec.gated_linear_step(*_t(q[:, :, t], k[:, :, t],
                                               v[:, :, t], lf[:, :, t]), state)
        steps.append(ht)
    np.testing.assert_allclose(torch.stack(steps, 2).numpy(),
                               whole[:, :, 15:].numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(head.numpy(), whole[:, :, :15].numpy(),
                               atol=1e-5, rtol=1e-4)


def test_error_bound_scales_with_the_row():
    want = torch.tensor([[100.0, 1e-3], [0.0, 0.0]])
    bound = mlstm_error_bound(want)
    assert float(bound[0, 1]) == pytest.approx(1e-5 + 1e-2)  # the row's scale
    assert float(bound[1, 0]) == pytest.approx(1e-5)


def test_tile_and_shared_memory():
    assert [launcher.tile(c, s) for c, s in
            ((64, 512), (64, 12), (128, 1000), (48, 1000), (16, 3))] == [
        64, 16, 128, 64, 16]
    with pytest.raises(ValueError, match="chunk"):
        launcher.tile(256, 1000)
    # the model path: chunk 64 at dk = 512 fits a block; chunk 128 does not
    assert launcher.smem_bytes(64, 512) == 213008 <= launcher.MAX_SMEM_BYTES
    # sharing the scores across a cluster takes a second P buffer
    assert launcher.smem_bytes(64, 512, 4) == 230416 <= launcher.MAX_SMEM_BYTES
    assert launcher.smem_bytes(128, 512) > launcher.MAX_SMEM_BYTES


def test_wrapper_refuses_other_devices():
    q, k, v, lf = _t(*_inputs(1, 1, 4, 8, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        mlstm_scan(q.to("meta"), k, v, lf)


def _bad(**kw):
    x = {"q": torch.ones(1, 2, 4, 8), "k": torch.ones(1, 2, 4, 8),
         "v": torch.ones(1, 2, 4, 6), "log_f": torch.zeros(1, 2, 4)}
    x.update(kw)
    return x


@pytest.mark.parametrize("args,chunk,match", [
    (_bad(q=torch.ones(1, 2, 4, 8, dtype=torch.float64)), 64, "float32"),
    (_bad(k=torch.ones(1, 2, 8, 4).transpose(2, 3)), 64, "contiguous"),
    (_bad(), 64, "CUDA"),
])
def test_cuda_launcher_refuses_before_launching(args, chunk, match):
    """No silent fallback and no bad launch: the launcher raises on what
    the kernel does not take (a CPU tensor included) before it builds or
    launches anything."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.mlstm_scan_cuda(**args, chunk=chunk)
    assert launcher.launches == before


@pytest.mark.parametrize("args,chunk,match", [
    (_bad(v=torch.ones(1, 2, 5, 6)), 64, "want k"),
    (_bad(q=torch.ones(1, 2, 200, 8), k=torch.ones(1, 2, 200, 8),
          v=torch.ones(1, 2, 200, 6), log_f=torch.zeros(1, 2, 200)), 256,
     "chunk"),
    (_bad(q=torch.ones(1, 2, 200, 512), k=torch.ones(1, 2, 200, 512),
          v=torch.ones(1, 2, 200, 6), log_f=torch.zeros(1, 2, 200)), 128,
     "shared memory"),
])
def test_cuda_launcher_refuses_shapes(args, chunk, match):
    """Shapes, chunk and shared memory are checked before the device (so
    meta tensors, which hold no data, reach those checks here)."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.mlstm_scan_cuda(**{k: v.to("meta") for k, v in args.items()},
                                 chunk=chunk)
    assert launcher.launches == before


def test_plain_version_matches_scan_with_chunk_free_math():
    """The chunk only sets the kernel's tile: the plain version has none,
    and gated_linear_scan gives the same result for every chunk."""
    q, k, v, lf = _t(*_inputs(1, 2, 96, 16, 16, seed=5))
    outs = [trec.gated_linear_scan(q, k, v, lf, chunk=c) for c in (16, 32, 96)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), mlstm_scan_ref(q, k, v, lf).numpy())
