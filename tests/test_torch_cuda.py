"""The port's CUDA kernels against their plain PyTorch versions, on the
card. JAX-free, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is false (a CUDA
kernel has no CPU mode; the CPU path is covered against JAX in
``tests/test_torch_wire_codec.py``). Tolerance: kernel and plain version
do the same IEEE f32 operations in the same order (``rintf`` and
``torch.round`` both round half to even), so outputs agree bit for bit.
"""
import numpy as np
import pytest
import torch

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
