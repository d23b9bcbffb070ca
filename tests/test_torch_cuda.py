"""The port's CUDA kernels against their plain PyTorch versions, on the
card. JAX-free, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is false (a CUDA
kernel has no CPU mode; the CPU paths are covered against JAX in
``tests/test_torch_wire_codec.py`` and ``tests/test_torch_blendavg.py``).
Tolerances: the wire codec's kernel and plain version do the same IEEE
f32 operations in the same order (``rintf`` and ``torch.round`` both
round half to even), so outputs agree bit for bit. The blend kernel sums
its L products in l order and the plain version in PyTorch's order, so
they agree within ``blend_error_bound``: 2 * L * eps32 * sum |omega x|,
plus one bf16 ulp for bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves, tree_stack
from repro_torch.kernels.blendavg import blendavg as blend_launcher
from repro_torch.kernels.blendavg.ops import blend_params
from repro_torch.kernels.blendavg.ref import blend_error_bound, blend_params_ref
from repro_torch.kernels.wire_codec import wire_codec as launcher
from repro_torch.kernels.wire_codec.ops import scale_thresh, wire_codec_roundtrip
from repro_torch.kernels.wire_codec.ref import wire_codec_ref


def _rows(l, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((l, n))
         * rng.uniform(0.1, 10.0, (l, 1))).astype(np.float32)
    x[0] = 0.0  # all-zero row
    x[-1, : n // 2] = 0.5  # ties at the threshold
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,quantize", [
    ((64, 1024), 256, True), ((16, 1024), None, True), ((2, 1024), 256, False),
    ((64, 25), 7, True), ((5, 4097), 1025, True), ((3, 300), None, False),
    # a training round's messages: rows far wider than the capped grid
    ((16, 1048576), 262144, True), ((1, 2097152), 524288, True),
    ((16, 131072), 32768, True),
])
def test_kernel_matches_plain_on_card(dtype, shape, k, quantize):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.from_numpy(_rows(*shape, seed=1)).cuda().to(getattr(torch, dtype))
    st = scale_thresh(x, k)
    before = launcher.launches
    got = launcher.wire_codec_cuda(x, st, quantize=quantize)
    want = wire_codec_ref(x, st, quantize=quantize)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    if k is None and not quantize:  # the dense identity
        assert torch.equal(got.view(bits), x.view(bits))


@pytest.mark.cuda
def test_roundtrip_on_card_launches_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.from_numpy(_rows(8, 1024, seed=2)).cuda()
    before = launcher.launches
    got = wire_codec_roundtrip(x, k=256, quantize=True)
    assert launcher.launches == before + 1
    want = wire_codec_roundtrip(x.cpu(), k=256, quantize=True)
    assert torch.equal(got.cpu(), want)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,n", [(3, 1000), (5, 2048), (2, 33), (7, 4097),
                                 (16, 131072), (17, 2097152)])
def test_blend_kernel_matches_plain_on_card(l, n, dtype):
    _skip_without_card()
    rng = np.random.default_rng(l)
    x = torch.from_numpy(rng.standard_normal((l, n)).astype(np.float32))
    x = x.cuda().to(getattr(torch, dtype))
    omega = rng.random(l).astype(np.float32)
    omega[0] = 0.0  # a discarded candidate
    omega = torch.from_numpy(omega / omega.sum()).cuda()
    before = blend_launcher.launches
    got = blend_launcher.blend_params_cuda(x, omega)
    want = blend_params_ref(x, omega)
    torch.cuda.synchronize()
    assert blend_launcher.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (n,)
    err = (got.float() - want.float()).abs()
    assert bool((err <= blend_error_bound(x, omega, want, got)).all())


@pytest.mark.cuda
def test_blend_kernel_zero_omega_on_card():
    _skip_without_card()
    x = torch.randn(4, 5000, device="cuda")
    x[1] = float("1e30")  # a discarded candidate's values never leak in
    omega = torch.tensor([0.25, 0.0, 0.75, 0.0], device="cuda")
    got = blend_launcher.blend_params_cuda(x, omega)
    want = blend_params_ref(x, omega)
    err = (got - want).abs()
    assert bool((err <= blend_error_bound(x, omega, want, got)).all())
    zero = blend_launcher.blend_params_cuda(x, torch.zeros(4, device="cuda"))
    assert bool((zero == 0).all())


@pytest.mark.cuda
def test_blend_params_launches_once_per_leaf_on_card():
    _skip_without_card()
    from repro_torch.core.encoders import EncoderConfig, init_client_models
    from repro_torch.data.synthetic import make_task

    gen = torch.Generator(device="cuda").manual_seed(0)
    spec, ecfg = make_task("conditions"), EncoderConfig(d_hidden=64, n_layers=2)
    tree = tree_stack([init_client_models(gen, spec, ecfg, device="cuda")
                       for _ in range(3)])
    omega = torch.tensor([0.2, 0.3, 0.5], device="cuda")
    before = blend_launcher.launches
    got = blend_params(tree, omega)
    assert blend_launcher.launches - before == len(tree_leaves(tree))
    for x, g in zip(tree_leaves(tree), tree_leaves(got)):
        flat = x.reshape(x.shape[0], -1)
        want = blend_params_ref(flat, omega)
        err = (g.reshape(-1) - want).abs()
        assert g.shape == x.shape[1:]
        assert bool((err <= blend_error_bound(flat, omega, want, g.reshape(-1))).all())
