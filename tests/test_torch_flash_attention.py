"""Flash attention of the PyTorch port against the JAX reference, on the
CPU: the kernel's plain version over the full interface (GQA, causal,
sliding window, queries end-aligned to the keys), and the wrapper's
routing.

The plain version is held against the reference's ``flash_attention_ref``
and its Pallas kernel in interpret mode, at the shapes and masks
``tests/test_kernels.py`` uses, within 2e-5 for f32 and 2e-2 for bf16
(the reference's kernel-test tolerances). Where the two references
differ, causal with Sq > Sk, the port follows the kernel: rows with no
visible key are 0 (the JAX ref gives NaN there). The CUDA kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention as launcher
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_scale, bf16_error_bound

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _check(q, k, v, dtype, *, causal, window=0, interpret=True):
    """The port's CPU path against the JAX ref and, when ``interpret``,
    the interpret-mode Pallas kernel, on the same inputs in ``dtype``."""
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    wants = [jax_ref(jq, jk, jv, causal=causal, window=window)]
    if interpret:
        wants.append(flash_attention_pallas(jq, jk, jv, causal=causal,
                                            window=window, block_q=32,
                                            block_k=32, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    return got


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 4, 4, 64, 64, 32),    # MHA square
    (2, 8, 2, 128, 128, 64),  # GQA 4x
    (1, 6, 2, 96, 96, 32),    # non-pow2 heads
    (2, 4, 1, 64, 192, 32),   # MQA, decode-style suffix queries
    (1, 4, 4, 40, 72, 16),    # ragged (the TPU kernel's padding path)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_jax(b, hq, hkv, sq, sk, d, dtype):
    # the interpret kernel once per shape (it is the slow part here)
    _check(*_qkv(b, hq, hkv, sq, sk, d, seed=sq + d), dtype, causal=True,
           interpret=dtype == "float32")


@pytest.mark.parametrize("window", [8, 32, 127])
def test_sliding_window_matches_jax(window):
    _check(*_qkv(1, 4, 2, 128, 128, 32, seed=window), "float32", causal=True,
           window=window)


def test_noncausal_matches_jax():
    _check(*_qkv(2, 4, 4, 64, 64, 32, seed=2), "float32", causal=False)


@pytest.mark.parametrize("d", [8, 10])
def test_noncausal_encoder_head_dims_match_jax_ref(d):
    """The transformer encoder's shapes: Sq = Sk, Hq = Hkv, small d."""
    _check(*_qkv(3, 4, 4, 12, 12, d, seed=d), "float32", causal=False,
           interpret=False)


def test_window_without_causal_matches_jax():
    _check(*_qkv(1, 2, 1, 37, 50, 16, seed=3), "float32", causal=False,
           window=5)


def test_rows_without_keys_are_zero_like_the_kernel():
    """Causal with Sq > Sk: the first Sq - Sk query rows see no key. The
    TPU kernel outputs 0 there and its ref NaN; the port follows the
    kernel, and agrees with both references on the other rows."""
    q, k, v = _qkv(2, 4, 2, 80, 48, 32, seed=5)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True).numpy()
    kernel = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True,
                                               block_q=32, block_k=32,
                                               interpret=True))
    ref = np.asarray(jax_ref(jq, jk, jv, causal=True))
    assert (got[:, :, :32] == 0).all() and (kernel[:, :, :32] == 0).all()
    assert np.isnan(ref[:, :, :32]).all()
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[:, :, 32:], ref[:, :, 32:], atol=2e-5,
                               rtol=2e-5)


def test_scale_rounds_like_the_reference():
    """1 / sqrt(d) as the TPU kernel and the JAX ref round it: an f32
    square root, then an f32 division."""
    for d in (8, 10, 32, 64, 100, 256):
        want = np.float32(1.0) / np.sqrt(np.float32(d))
        assert float(attention_scale(d)) == float(want)


def _rna_tf32(x):
    """cvt.rna.tf32.f32 on the CPU: round an f32 to TF32's 10 mantissa
    bits, to nearest with ties away from zero (finite values)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, passes):
    """a @ b as the f32 kernel's tensor cores form it: operands rounded to
    TF32 (exact products, f32 sums); 3 passes is the 3xTF32 split
    small*big + big*small + big*big, 1 pass plain TF32."""
    a_big, b_big = _rna_tf32(a), _rna_tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _rna_tf32(a - a_big), _rna_tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_tf32_split_arithmetic_meets_the_f32_tolerance(passes, within):
    """The arithmetic model of the f32 kernel's products: q, k, p and v
    split into TF32 big + small parts (3xTF32) stay within TOL[float32] of
    the plain version at (8, 4, 64, 256); plain (1x) TF32 does not, by a
    wide margin (about 2e-6 against 7e-4 here), which is why the kernel
    never takes it."""
    q, k, v = _qkv(8, 4, 4, 64, 64, 256, seed=0)
    want = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=False).numpy()
    s = _tf32_product(q, np.swapaxes(k, -1, -2), passes) * np.float32(
        attention_scale(256))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    got = _tf32_product(p, v, passes) / p.sum(-1, keepdims=True)
    err = np.abs(got - want)
    tol = TOL["float32"]
    assert bool((err <= tol + tol * np.abs(want)).all()) == within
    if within:
        assert err.max() < 5e-6
    else:
        assert err.max() > 2e-4


def _bf16_kernel_model(q, k, v, *, causal):
    """The bf16 kernel's arithmetic on the CPU: exact products of the bf16
    q and k summed in f32, the softmax and its row sum l in f32, each p
    rounded to bf16 for the P V product (exact products, f32 sums), the
    output acc / l rounded to bf16."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * attention_scale(q.shape[-1])
    sq, sk = s.shape[-2:]
    if causal:
        qi = torch.arange(sq)[:, None] + (sk - sq)
        s = s.masked_fill(torch.arange(sk)[None, :] > qi, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [(2, 4, 2, 1, 8192, False),
                                                   (1, 4, 2, 512, 512, True)])
@pytest.mark.parametrize("misread", [False, True])
def test_bf16_error_bound_holds_for_the_kernel_arithmetic(b, hq, hkv, sq, sk, causal,
                                                          misread):
    """The model of the bf16 kernel's arithmetic stays within
    ``bf16_error_bound`` of the plain version (odd query heads at 4 times
    the scale, their softmax on a few keys); fed V with a quarter of its
    keys negated (a kernel that misreads them), it does not."""
    gen = torch.Generator().manual_seed(sq + sk)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16() for shape in (
        (b, hq, sq, 64), (b, hkv, sk, 64), (b, hkv, sk, 64)))
    q[:, 1::2] *= 4
    fed = v.clone()
    if misread:
        fed[:, :, 3 * sk // 8:5 * sk // 8] *= -1
    got = _bf16_kernel_model(q, k, fed, causal=causal)
    want = flash_attention(q, k, v, causal=causal)
    within = (got.float() - want.float()).abs() <= bf16_error_bound(
        q, k, v, got, want, causal=causal)
    assert bool(within.all()) != misread


def test_wrapper_refuses_other_devices():
    q, k, v = (torch.from_numpy(x).to("meta") for x in _qkv(1, 1, 1, 2, 2, 4, 0))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        flash_attention(q, k, v)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _m(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("q,k,v,match", [
    (_t(1, 2, 4, 8, dtype=torch.float64), _t(1, 2, 4, 8, dtype=torch.float64),
     _t(1, 2, 4, 8, dtype=torch.float64), "float32 or bfloat16"),
    (_t(1, 2, 4, 8), _t(1, 2, 4, 8, dtype=torch.bfloat16), _t(1, 2, 4, 8),
     "one dtype"),
    (_t(1, 2, 4, 8), _t(1, 2, 4, 8), _t(1, 2, 5, 8), "want q"),
    (_t(1, 3, 4, 8), _t(1, 2, 4, 8), _t(1, 2, 4, 8), "multiple of Hkv"),
    (_t(1, 2, 4, 8), _t(1, 2, 4, 6), _t(1, 2, 4, 6), "same batch and d"),
    (_t(1, 2, 8, 4).transpose(2, 3), _t(1, 2, 4, 8), _t(1, 2, 4, 8),
     "contiguous"),
    (_t(1, 1, 2, 264), _t(1, 1, 2, 264), _t(1, 1, 2, 264), "at most 256"),
    (_t(1, 2, 4, 8), _t(1, 2, 4, 8), _t(1, 2, 4, 8), "CUDA"),
    # the grid: 65535 blocks of BLOCK_M rows over the (Hq / Hkv) * Sq query
    # rows of a K/V group; 4 query heads a K/V head pass the limit that 4
    # K/V heads of their own keep (shapes only: meta tensors hold no data)
    (_m(1, 4, launcher.MAX_GROUP_ROWS // 4 + 1, 8), _m(1, 1, 4, 8),
     _m(1, 1, 4, 8), "exceed the grid"),
    (_m(1, 1, launcher.MAX_GROUP_ROWS + 1, 8), _m(1, 1, 4, 8), _m(1, 1, 4, 8),
     "exceed the grid"),
    (_m(1, 4, launcher.MAX_GROUP_ROWS // 4 + 1, 8), _m(1, 4, 4, 8),
     _m(1, 4, 4, 8), "CUDA"),
])
def test_cuda_launcher_refuses_before_launching(q, k, v, match):
    """No silent fallback and no bad launch: the launcher raises on what
    the kernel does not take (a CPU tensor included) before it builds or
    launches anything."""
    before = launcher.launches
    with pytest.raises(ValueError, match=match):
        launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
    assert launcher.launches == before
