"""The wire codec's on-card selection of [scale, thresh], mirrored on the
CPU (JAX-free).

``radix_scale_thresh`` below is a plain torch copy of what
``wire_codec.cu`` computes per row: the largest 32-bit |x| key (the f32
bits with the sign cleared, bf16 widened exactly) as the scale, clamped
at 1e-30 with NaN kept, and the k-th largest key by a radix select over
the digits ``wire_codec.DIGITS`` (11 + 11 + 10 bits; a bf16 key needs the
first two), each pass counting the keys that match the digits chosen so
far. It is held bit for bit (NaN as equal) against ``ops.scale_thresh``,
the library top-k that feeds the plain version, on the rows that make a
select go wrong: all-zero rows, ties at the threshold of both signs, NaN
and +-inf, subnormals, bf16, k = 1, k = N - 1, k >= N and N = 1. The
kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.wire_codec import wire_codec as launcher
from repro_torch.kernels.wire_codec.ops import scale_thresh, wire_codec_roundtrip

EPS = np.float32(1e-30)


def _keys(x: torch.Tensor) -> torch.Tensor:
    """int64 (L, N) |x| keys: the f32 bits of x widened, sign cleared."""
    return x.float().contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF


def _as_f32(key: torch.Tensor) -> torch.Tensor:
    return key.to(torch.int32).view(torch.float32)


def radix_scale_thresh(x: torch.Tensor, k):
    """(L, 2) f32 [scale, thresh] of x (L, N) as the codec's kernels
    select them."""
    keys = _keys(x)
    n = x.shape[1]
    scale = _as_f32(keys.max(dim=1).values)
    scale = torch.where(scale < EPS, torch.full_like(scale, EPS), scale)
    thresh = torch.zeros_like(scale)
    if k is not None and k < n:
        digits = launcher.DIGITS if x.dtype == torch.float32 else launcher.DIGITS[:2]
        for r in range(x.shape[0]):
            prefix, rank = 0, k
            for p, (shift, width) in enumerate(digits):
                match = keys[r] if p == 0 else keys[r][(keys[r] >> (shift + width)) == prefix]
                hist = torch.bincount((match >> shift) & ((1 << width) - 1),
                                      minlength=1 << width)
                from_top = hist.flip(0).cumsum(0).flip(0)  # keys with digit >= d
                d = int(torch.nonzero(from_top >= rank).max())
                rank -= int(from_top[d] - hist[d])
                prefix = (prefix << width) | d
            thresh[r] = _as_f32(torch.tensor(prefix << digits[-1][0]))
    return torch.stack([scale, thresh], dim=1)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _row_cases():
    rng = np.random.default_rng(0)
    n = 1024
    base = (rng.standard_normal((3, n)) * rng.uniform(0.1, 10.0, (3, 1))).astype(np.float32)
    zero = np.zeros((2, n), np.float32)
    ties = rng.uniform(-0.4, 0.4, (2, n)).astype(np.float32)
    ties[:, : n // 2] = np.where(np.arange(n // 2) % 2, 0.5, -0.5)  # both signs
    special = base.copy()
    special[0, [3, 99, 500]] = np.nan
    special[1, [7, 8]] = [np.inf, -np.inf]
    special[2, 10] = -np.nan
    special[2, 11] = np.inf
    sub = (rng.standard_normal((2, n)) * 1e-41).astype(np.float32)  # subnormals
    sub[1, ::3] = 0.0
    sub[1, 1::3] = -sub[1, 1::3]
    mixed = np.concatenate([sub[:1, : n // 2], base[:1, : n // 2]], axis=1)
    negzero = np.where(rng.random((1, n)) < 0.5, -0.0, 0.0).astype(np.float32)
    return {"normal": base, "zero": zero, "ties": ties, "nan_inf": special,
            "subnormal": sub, "subnormal_and_normal": mixed, "negative_zero": negzero}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_row_cases()))
@pytest.mark.parametrize("k", [1, 2, 256, 511, 512, 513, 1023, 1024, 5000, None])
def test_digit_schedule_matches_library_topk(dtype, case, k):
    x = torch.from_numpy(_row_cases()[case]).to(dtype)
    assert _bits_equal(radix_scale_thresh(x, k), scale_thresh(x, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(1, 1), (1, None), (2, 1), (25, 7), (25, 24),
                                 (4097, 1025), (4097, 4096), (300, 300)])
def test_digit_schedule_at_edge_widths(dtype, n, k):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((4, n)).astype(np.float32)).to(dtype)
    x[1] = x[1].abs()  # one sign only
    x[2] = torch.round(x[2])  # many exact ties, zeros among them
    assert _bits_equal(radix_scale_thresh(x, k), scale_thresh(x, k))


def test_every_key_bit_is_selected():
    """Keys that differ only in the lowest digit's bits (f32), or only in
    the second digit's bits (bf16): each pass must decide."""
    base = 0x3F800000  # 1.0
    keys = torch.tensor([[base + i for i in range(0, 1 << 12, 3)]], dtype=torch.int64)
    x = _as_f32(keys)
    for k in (1, 2, 700, 1365):
        assert _bits_equal(radix_scale_thresh(x, k), scale_thresh(x, k))
    xb = x.bfloat16()
    for k in (1, 5, 40):
        assert _bits_equal(radix_scale_thresh(xb, k), scale_thresh(xb, k))


def test_roundtrip_refuses_k_below_one():
    with pytest.raises(ValueError, match="at least 1"):
        wire_codec_roundtrip(torch.ones(2, 8), k=0, quantize=True)


@pytest.mark.parametrize("x,k,match", [
    (torch.ones(2, 8), 2, "CUDA"),
    (torch.ones(2, 8, dtype=torch.float64), 2, "CUDA"),
])
def test_fused_launcher_refuses_before_launching(x, k, match):
    """No silent fallback: the fused launcher raises on a CPU tensor
    before it builds or launches anything."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.wire_codec_fused(x, k=k, quantize=True)
    assert launcher.launches == before
