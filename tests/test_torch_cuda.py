"""The port's CUDA kernels against their plain PyTorch versions, on the
card. JAX-free, so that it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips where ``torch.cuda.is_available()`` is false (a CUDA
kernel has no CPU mode; the CPU paths are covered against JAX in
``tests/test_torch_wire_codec.py`` and ``tests/test_torch_blendavg.py``).
Tolerances: the wire codec's kernel and plain version do the same IEEE
f32 operations in the same order (``rintf`` and ``torch.round`` both
round half to even), so outputs agree bit for bit; the codec's on-card
selection of [scale, thresh] is exact, so the fused op's [scale, thresh]
and output equal ``scale_thresh`` + the plain version bit for bit (NaN
as equal). A tree blend equals one-leaf blends of the same kernel bit
for bit (each column is summed the same way). The blend kernel sums
its L products in l order and the plain version in PyTorch's order, so
they agree within ``blend_error_bound``: 2 * L * eps32 * sum |omega x|,
plus one bf16 ulp for bf16. The sLSTM kernel's recurrent products sum in
another order than the plain version's: within ``slstm_error_bound``
(atol 1e-5, rtol 1e-4, plus one bf16 ulp for bf16). Flash attention
against its plain version: 2e-5 in f32 and 2e-2 in bf16, the reference's
kernel-test tolerances. The mLSTM scan's h and final (C, n) against the
step recurrence: within ``mlstm_error_bound`` (atol 1e-5 plus 1e-4 of the
row's largest value: dot products of dk terms summed in another order,
the decay factored per chunk). The mLSTM backward kernel against the
plain step-by-step backward, fed the same h: within
``mlstm_grad_error_bound`` (atol 1e-5 plus 1e-4 of the row's largest
gradient; for dq, of its row's largest summand, as dq is a difference of
two larger terms). The sLSTM from a running state: output
and final state within ``slstm_error_bound``. The reduced xlstm through
``serve_lm`` on the card against the CPU: logits within 1e-3, as every
reduced family's. The flash kernel's logit cap against the plain
version's at the f32 / bf16 tolerances.
"""
import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves, tree_stack
from repro_torch.kernels.blendavg import blendavg as blend_launcher
from repro_torch.kernels.blendavg.ops import blend_params
from repro_torch.kernels.blendavg.ref import blend_error_bound, blend_params_ref
from repro_torch.kernels.flash_attention import flash_attention as flash_launcher
from repro_torch.kernels.flash_attention.ref import TOL as FLASH_TOL
from repro_torch.kernels.flash_attention.ref import bf16_error_bound as flash_bf16_error_bound
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mlstm_scan import mlstm_scan as mlstm_launcher
from repro_torch.kernels.mlstm_scan.ref import mlstm_error_bound, mlstm_scan_ref
from repro_torch.kernels.slstm_cell import slstm_cell as slstm_launcher
from repro_torch.kernels.slstm_cell.ref import slstm_cell_ref, slstm_error_bound
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


# the phase-3 serving shapes (features, scores, ragged) and the five
# training message shapes (chip_smoke.TRAIN_CODEC_SHAPES), k a quarter
CODEC_OP_SHAPES = [((2, 1024), 256), ((16, 1024), 256), ((64, 1024), 256),
                   ((64, 25), 7), ((5, 4097), 1025), ((3, 8192), 2048),
                   ((2, 8193), 2049), ((16, 1048576), 262144),
                   ((1, 2097152), 524288), ((16, 131072), 32768),
                   ((4, 1048576), 262144), ((4, 131072), 32768)]
CODECS = {"int8": (False, True), "topk": (True, False),
          "int8_topk": (True, True), "identity": (False, False)}


def _nan_equal(a, b):
    """Bit for bit, NaN as equal."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(bits), b[~nan].view(bits)))


def _check_fused(x, k, quantize):
    before = launcher.launches
    got, st = launcher.wire_codec_fused(x, k=k, quantize=quantize)
    want_st = scale_thresh(x, k)
    want = wire_codec_ref(x, want_st, quantize=quantize)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    assert _nan_equal(st, want_st), (st[:4], want_st[:4])
    assert _nan_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", CODEC_OP_SHAPES)
def test_codec_op_selects_and_matches_plain_on_card(shape, k, dtype, codec):
    """The fused op's output and [scale, thresh] against the library
    top-k and the plain version, on narrow and wide rows (an all-zero row
    and ties at the threshold of both signs among them)."""
    _skip_without_card()
    sparse, quantize = CODECS[codec]
    x = torch.from_numpy(_rows(*shape, seed=3)).cuda().to(getattr(torch, dtype))
    if shape[0] > 1:
        x[-1, 1::2] = -x[-1, 1::2]
    _check_fused(x, k if sparse else None, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1024, 131072])
def test_codec_op_special_values_on_card(dtype, n):
    """NaN, +-inf, subnormals, -0.0, k = 1, k = N - 1 and N = 1."""
    _skip_without_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((6, n)).astype(np.float32))
    x[0, [3, 99, 500]] = float("nan")
    x[1, [7, 8]] = torch.tensor([float("inf"), float("-inf")])
    x[2] = x[2] * 1e-41  # subnormal
    x[3] = torch.where(x[3] > 0, torch.tensor(0.0), torch.tensor(-0.0))
    x[4] = torch.round(x[4])
    x = x.cuda().to(getattr(torch, dtype))
    for k in (1, 2, n // 4, n - 1, n, None):
        for quantize in (True, False):
            _check_fused(x, k, quantize)
    for k in (1, None):
        _check_fused(x[:, :1].contiguous(), k, True)


@pytest.mark.cuda
def test_codec_op_runs_no_library_topk_and_reads_nothing_on_card(monkeypatch):
    """On the card the round trip selects in its own kernels: torch.topk
    is never called, and no value is read on the host (the sync debug
    mode raises on a synchronizing call)."""
    _skip_without_card()

    def refuse(*a, **k):
        raise AssertionError("torch.topk called on the CUDA path")

    xs = [torch.from_numpy(_rows(*shape, seed=4)).cuda() for shape, _ in
          (((64, 1024), 0), ((16, 131072), 0))]
    for x in xs:  # build and load first: the build itself may synchronize
        wire_codec_roundtrip(x, k=x.shape[1] // 4, quantize=True)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch, "topk", refuse)
    monkeypatch.setattr(torch.Tensor, "topk", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in xs:
            wire_codec_roundtrip(x, k=x.shape[1] // 4, quantize=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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
    """A stacked model tree blends in one launch of the tree kernel (a
    group of at most 64 leaves a launch), each leaf within its bound."""
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
    n_leaves = len(tree_leaves(tree))
    assert blend_launcher.launches - before == blend_launcher.launches_for(n_leaves) == 1
    for x, g in zip(tree_leaves(tree), tree_leaves(got)):
        flat = x.reshape(x.shape[0], -1)
        want = blend_params_ref(flat, omega)
        err = (g.reshape(-1) - want).abs()
        assert g.shape == x.shape[1:]
        assert bool((err <= blend_error_bound(flat, omega, want, g.reshape(-1))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [1, 4, 5, 16, 17])
def test_tree_blend_equals_one_leaf_blends_on_card(l, dtype):
    """One launch over leaves of every path (16-byte, a 25-wide head,
    ragged, a leaf whose storage starts off a 16-byte boundary) equals
    one-leaf launches bit for bit and keeps each leaf in storage of its
    own; 130 leaves split into 3 launches."""
    _skip_without_card()
    rng = np.random.default_rng(l)
    dt = getattr(torch, dtype)
    cols = [1024, 25, 4097, 131072, 1, 8, 1000, 25 * 1024]
    leaves = [torch.from_numpy(rng.standard_normal((l, n)).astype(np.float32))
              .cuda().to(dt) for n in cols]
    buf = torch.from_numpy(rng.standard_normal(l * 512 + 1).astype(np.float32)).cuda().to(dt)
    leaves.append(buf[1:].reshape(l, 512))  # contiguous, misaligned
    omega = rng.random(l).astype(np.float32)
    omega = torch.from_numpy(omega / omega.sum()).cuda()
    before = blend_launcher.launches
    got = blend_launcher.blend_tree_cuda(leaves, omega)
    assert blend_launcher.launches - before == 1
    assert len({g.data_ptr() for g in got}) == len(got)
    for x, g in zip(leaves, got):
        one = blend_launcher.blend_params_cuda(x, omega)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        assert torch.equal(g.view(bits), one.view(bits))
        want = blend_params_ref(x, omega)
        err = (g.float() - want.float()).abs()
        assert bool((err <= blend_error_bound(x, omega, want, g)).all())
    many = [leaves[i % len(leaves)][:, :77].contiguous() for i in range(130)]
    before = blend_launcher.launches
    out = blend_launcher.blend_tree_cuda(many, omega)
    assert blend_launcher.launches - before == 3 == blend_launcher.launches_for(130)
    for x, g in zip(many, out):
        assert torch.equal(g, blend_launcher.blend_params_cuda(x, omega))


# ---------------------------------------------------------- sLSTM cell --

def _slstm_inputs(b, h, s, hd, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((b, h, s, 4, hd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((h, hd, 4 * hd)) / np.sqrt(hd)).astype(np.float32)
    return (torch.from_numpy(pre).cuda().to(dtype),
            torch.from_numpy(r).cuda().to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd,dtype", [
    (1, 2, 32, 16, "float32"), (2, 4, 50, 8, "float32"),
    (1, 1, 64, 32, "float32"), (2, 4, 64, 256, "float32"),
    (3, 2, 17, 100, "float32"), (2, 4, 50, 8, "bfloat16"),
    (2, 4, 64, 256, "bfloat16"),
    # the cluster design's edges: several row groups with a ragged last
    # one (rows 20 and 5 a cluster), H = 1, a ragged last CTA of units
    (65, 4, 3, 256, "float32"), (17, 4, 50, 256, "float32"),
    (37, 1, 20, 256, "float32"), (5, 3, 9, 255, "float32"),
    (17, 4, 50, 256, "bfloat16"),
])
def test_slstm_kernel_matches_plain_on_card(b, h, s, hd, dtype):
    _skip_without_card()
    pre, r = _slstm_inputs(b, h, s, hd, seed=hd, dtype=getattr(torch, dtype))
    before = slstm_launcher.launches
    got = slstm_launcher.slstm_cell_cuda(pre, r)
    want = slstm_cell_ref(pre, r)
    torch.cuda.synchronize()
    assert slstm_launcher.launches == before + 1
    assert got.dtype == pre.dtype and got.shape == (b, h, s, hd)
    err = (got.float() - want.float()).abs()
    assert bool((err <= slstm_error_bound(want, got)).all()), float(err.max())


@pytest.mark.cuda
def test_slstm_launcher_refuses_wide_heads_on_card():
    _skip_without_card()
    pre, r = _slstm_inputs(1, 1, 2, 264, seed=0)
    before = slstm_launcher.launches
    with pytest.raises(ValueError, match="at most 256"):
        slstm_launcher.slstm_cell_cuda(pre, r)
    assert slstm_launcher.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_plan_matches_the_kernels_on_card(dtype):
    """The Python mirror of the kernel's partition (checked on the CPU by
    tests/test_torch_slstm_plan.py) is the plan the built kernel makes
    with the card's cluster budget; its clusters fit the budget unless
    the heads or the 32-row cap need more, and the card holds one."""
    _skip_without_card()
    for b, h, hd in ((64, 4, 256), (2, 4, 256), (8, 4, 256), (65, 4, 256),
                     (17, 4, 256), (37, 1, 256), (3, 2, 100), (10, 4, 256),
                     (128, 8, 256), (1, 1, 8), (300, 2, 64)):
        got, budget, active = slstm_launcher.kernel_plan(b, h, hd,
                                                          getattr(torch, dtype))
        assert got == slstm_launcher.plan(b, h, hd, budget), (b, h, hd)
        assert (h * got.groups <= max(budget, h)
                or got.rows == slstm_launcher.MAX_ROWS), (b, h, hd, got, budget)
        assert active >= 1, (b, h, hd, got)


# ----------------------------------------------------- flash attention --

FLASH_CASES = [  # b, hq, hkv, sq, sk, d, causal, window
    (1, 4, 4, 64, 64, 32, True, 0), (2, 8, 2, 128, 128, 64, True, 0),
    (1, 6, 2, 96, 96, 32, True, 0), (2, 4, 1, 64, 192, 32, True, 0),
    (1, 4, 4, 40, 72, 16, True, 0), (1, 4, 2, 128, 128, 32, True, 8),
    (1, 4, 2, 128, 128, 32, True, 32), (1, 4, 2, 128, 128, 32, True, 127),
    (2, 4, 4, 64, 64, 32, False, 0), (2, 4, 4, 64, 64, 256, False, 0),
    (1, 2, 2, 12, 12, 8, False, 0), (1, 2, 1, 37, 50, 10, False, 5),
]


def _qkv(b, hq, hkv, sq, sk, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(x.cuda().to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(b, hq, hkv, sq, sk, d, causal,
                                            window, dtype):
    _skip_without_card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=sq + d, dtype=dt)
    before = flash_launcher.launches
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_launcher.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = FLASH_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the edges of the kernel's tiling: a block holds 64 query rows of one
# K/V group (its query heads' rows one after another) and walks 32-key
# tiles. b, hq, hkv, sq, sk, d, causal, window
FLASH_EDGE_CASES = [
    (2, 4, 4, 97, 97, 64, False, 0),    # Sq not a multiple of 64
    (1, 4, 1, 33, 77, 10, False, 0),    # Sk not a multiple of 32; d = 10
    (1, 8, 2, 16, 16, 10, True, 0),     # d = 10, 4 heads a K/V head in one block
    (2, 8, 2, 77, 77, 256, False, 0),   # d = 256, 4 heads a K/V head
    (2, 4, 2, 80, 48, 32, True, 0),     # causal, Sq > Sk: rows without keys
    (1, 4, 1, 97, 77, 16, True, 0),     # the same across heads in a block
    (1, 4, 2, 100, 130, 16, True, 40),  # a window across key tiles
    (1, 4, 2, 128, 128, 32, False, 45),  # a window without causal
    (1, 8, 2, 1024, 1024, 128, True, 0),  # long causal GQA
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", FLASH_EDGE_CASES)
def test_flash_kernel_tiling_edges_on_card(b, hq, hkv, sq, sk, d, causal,
                                           window, dtype):
    """One launch, within the tolerance of the plain version, finite, and
    the rows that see no key exactly 0."""
    _skip_without_card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=sq + sk + d, dtype=dt)
    before = flash_launcher.launches
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_launcher.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())
    tol = FLASH_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the language models' shapes (serve_lm): b, hq, hkv, sq, sk, d, causal, window
FLASH_LM_CASES = [
    (8, 24, 8, 512, 512, 128, True, 0),      # phi4-mini prefill
    (2, 25, 5, 2048, 2048, 64, True, 1024),  # hymba, sliding window
    (2, 16, 16, 4, 1500, 64, False, 0),      # whisper cross-attention
    (8, 24, 8, 1, 544, 128, False, 0),       # decode, group 3
    (2, 25, 5, 1, 544, 64, False, 0),        # decode, group 5
    (2, 12, 2, 1, 544, 128, False, 0),       # decode, group 6
    (2, 36, 4, 1, 544, 128, False, 0),       # decode, group 9
    (2, 32, 32, 128, 128, 80, True, 0),      # stablelm, head dim 80
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", FLASH_LM_CASES)
def test_flash_kernel_lm_shapes_on_card(b, hq, hkv, sq, sk, d, causal, window):
    _skip_without_card()
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=hq + sq)
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=causal,
                                              window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# bf16 at the production entries' lengths (launch/specs.py: one card's
# share of prefill_32k, decode_32k and long_500k): b, hq, hkv, sq, sk, d,
# causal, window, and K/V as a decode cache read in place ((B, Sk, Hkv, d)
# transposed, the strides decode_attend passes) or contiguous
FLASH_PRODUCTION_CASES = [
    (8, 24, 8, 1, 32768, 128, False, 0, True),     # phi4 decode_32k
    (1, 24, 8, 1, 4096, 128, False, 0, True),      # the window-4096 ring
    (1, 24, 8, 8192, 8192, 128, True, 4096, False),  # the window-4096 prefill
    (8, 12, 2, 1, 32768, 128, False, 0, True),     # qwen2-vl decode, group 6
    (8, 25, 5, 1, 1024, 64, False, 0, True),       # hymba's 1024 ring
    (2, 25, 5, 4096, 4096, 64, True, 1024, False),  # hymba's window 1024
    (2, 32, 32, 2048, 2048, 80, True, 0, False),   # stablelm d = 80
    (8, 32, 32, 1, 32768, 80, False, 0, True),     # stablelm d = 80 decode
    (2, 16, 16, 8192, 1500, 64, False, 0, False),  # whisper cross, prefill
    (8, 16, 16, 1, 1500, 64, False, 0, False),     # whisper cross, decode
    (2, 24, 8, 32768, 32768, 128, True, 0, False),  # phi4 prefill_32k
    (2, 12, 2, 32768, 32768, 128, True, 0, False),  # qwen2-vl prefill_32k
    (2, 36, 4, 32768, 32768, 128, True, 0, False),  # starcoder2 prefill_32k
]
FLASH_CHECK_ROWS = 128


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,in_place",
                         FLASH_PRODUCTION_CASES)
def test_flash_kernel_bf16_production_forms_on_card(b, hq, hkv, sq, sk, d, causal,
                                                    window, in_place):
    """One launch, finite, within ``bf16_error_bound`` of the plain version
    (which scales with each row's keys, so it stays sensitive where a long
    row's outputs are small): every row up to 1024 queries, else the
    first, middle and last 128 (queries end-aligned, each part given the
    keys up to its last row's). Odd query heads at 4 times the scale, so
    that their softmax rests on a few keys."""
    _skip_without_card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + d)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q = draw(b, hq, sq, d)
    q[:, 1::2] *= 4
    if in_place:
        k, v = draw(b, sk, hkv, d).transpose(1, 2), draw(b, sk, hkv, d).transpose(1, 2)
        assert not k.is_contiguous()
    else:
        k, v = draw(b, hkv, sk, d), draw(b, hkv, sk, d)
    before = flash_launcher.launches
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_launcher.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    n = FLASH_CHECK_ROWS
    parts = ([(0, sq)] if sq <= 1024 else
             [(0, n), (sq // 2 - n // 2, sq // 2 + n // 2), (sq - n, sq)])
    for lo, hi in parts:
        end = hi + sk - sq if causal else sk
        qq, kk, vv, out = q[:, :, lo:hi], k[:, :, :end], v[:, :, :end], got[:, :, lo:hi]
        want = flash_attention_ref(qq, kk, vv, causal=causal, window=window)
        assert bool(torch.isfinite(out.float()).all())
        bound = flash_bf16_error_bound(qq, kk, vv, out, want, causal=causal,
                                       window=window)
        assert bool(((out.float() - want.float()).abs() <= bound).all())
    if in_place:  # read in place or from a contiguous copy: the same bits
        again = flash_launcher.flash_attention_cuda(
            q, k.contiguous(), v.contiguous(), causal=causal, window=window)
        assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 5.0, 30.0])
def test_flash_kernel_softcap_on_card(dtype, softcap):
    """The logit cap against the plain version; a cap of 0 gives the
    uncapped kernel's output bit for bit."""
    _skip_without_card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, 8, 2, 96, 96, 64, seed=3, dtype=dt)
    q = q * 3  # scores of several units, so that the cap bends them
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0,
                                              softcap=softcap)
    want = flash_attention_ref(q, k, v, causal=True, softcap=softcap)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if not softcap:
        assert torch.equal(got, flash_launcher.flash_attention_cuda(
            q, k, v, causal=True, window=0))


@pytest.mark.cuda
def test_flash_kernel_rows_without_keys_are_zero_on_card():
    """Causal with Sq > Sk: the first Sq - Sk query rows see no key and
    are exactly 0, as in the TPU kernel."""
    _skip_without_card()
    q, k, v = _qkv(2, 4, 2, 80, 48, 32, seed=5)
    got = flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
    want = flash_attention_ref(q, k, v, causal=True, window=0)
    assert bool((got[:, :, :32] == 0).all())
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
def test_encoder_launches_its_kernel_once_on_card(enc_type):
    """One encoder application is one launch of its kernel and none of
    the other's, and the card agrees with the CPU on the same weights."""
    _skip_without_card()
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.encoders import EncoderConfig, encoder_apply, encoder_init

    ecfg = EncoderConfig(d_hidden=64, n_layers=1, enc_type=enc_type)
    p = encoder_init(torch.Generator().manual_seed(0), 12, ecfg, device="cuda")
    x = torch.randn(5, 16, 12, generator=torch.Generator().manual_seed(1))
    before = (slstm_launcher.launches, flash_launcher.launches)
    with torch.no_grad():
        got = encoder_apply(p, x.cuda(), ecfg)
    torch.cuda.synchronize()
    after = (slstm_launcher.launches, flash_launcher.launches)
    want_delta = (1, 0) if enc_type == "recurrent" else (0, 1)
    assert tuple(a - b for a, b in zip(after, before)) == want_delta
    want = encoder_apply(params_from_numpy(params_to_numpy(p), "cpu"), x, ecfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- mLSTM scan --

def _mlstm_inputs(b, h, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dk)).astype(np.float32)
    k = (rng.standard_normal((b, h, s, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    lf = (-np.abs(rng.standard_normal((b, h, s))) * 0.2).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (q, k, v, lf)]


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 2, 64, 16, 16, 16), (2, 3, 100, 32, 16, 32), (1, 1, 128, 64, 64, 128),
    (2, 4, 77, 512, 512, 64), (1, 2, 12, 64, 100, 64), (2, 4, 512, 512, 512, 64),
    (2, 25, 2048, 16, 64, 64),  # hymba's Mamba heads
])
def test_mlstm_kernel_matches_plain_on_card(b, h, s, dk, dv, chunk, normalize):
    """h and the final (C, n) within mlstm_error_bound of the step
    recurrence; S not a multiple of the chunk included."""
    _skip_without_card()
    q, k, v, lf = _mlstm_inputs(b, h, s, dk, dv, seed=s + dk)
    before = mlstm_launcher.launches
    got, (c, n) = mlstm_launcher.mlstm_scan_cuda(q, k, v, lf, chunk=chunk,
                                                 normalize=normalize,
                                                 return_state=True)
    want, (wc, wn) = mlstm_scan_ref(q, k, v, lf, normalize=normalize,
                                    return_state=True)
    torch.cuda.synchronize()
    assert mlstm_launcher.launches == before + 1
    for g, w in ((got, want), (c, wc), (n, wn)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = (g - w).abs()
        assert bool((err <= mlstm_error_bound(w)).all()), float(err.max())


def _check_mlstm_on_card(b, h, s, dk, dv, chunk, normalize=True):
    q, k, v, lf = _mlstm_inputs(b, h, s, dk, dv, seed=s + dk + dv)
    before = mlstm_launcher.launches
    got, (c, n) = mlstm_launcher.mlstm_scan_cuda(q, k, v, lf, chunk=chunk,
                                                 normalize=normalize,
                                                 return_state=True)
    want, (wc, wn) = mlstm_scan_ref(q, k, v, lf, normalize=normalize,
                                    return_state=True)
    torch.cuda.synchronize()
    assert mlstm_launcher.launches == before + 1
    for g, w in ((got, want), (c, wc), (n, wn)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = (g - w).abs()
        assert bool((err <= mlstm_error_bound(w)).all()), float(err.max())


# the edges of the tensor-core design: b, h, s, dk, dv, chunk
MLSTM_EDGE_CASES = [
    (1, 2, 40, 30, 50, 16),     # dk and dv not multiples of 4: scalar staging
    (2, 2, 70, 64, 37, 32),     # dv not a multiple of 4
    (1, 3, 45, 18, 64, 64),     # dk not a multiple of 4
    (3, 1, 90, 64, 320, 64),    # 5 column blocks: the last cluster not full
    (1, 2, 100, 64, 192, 32),   # 3 column blocks
    (2, 2, 40, 64, 64, 64),     # S < chunk
    (2, 3, 1, 64, 64, 64),      # S = 1
    (1, 2, 300, 352, 128, 128),  # chunk 128 at the largest dk that fits
    (1, 2, 150, 672, 64, 64),   # chunk 64 at the largest dk (TK = 16)
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dk,dv,chunk", MLSTM_EDGE_CASES)
def test_mlstm_kernel_edges_on_card(b, h, s, dk, dv, chunk):
    _skip_without_card()
    _check_mlstm_on_card(b, h, s, dk, dv, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,b,h,s,dk,dv,chunk", [
    (1, 1, 2, 100, 64, 64, 64),     # one column block
    (2, 1, 3, 100, 64, 128, 64),
    (2, 2, 2, 50, 48, 192, 64),     # 3 column blocks: the last cluster not full
    (4, 1, 2, 77, 512, 320, 64),    # 5 column blocks in 2 clusters of 4
    (8, 2, 4, 77, 512, 512, 64),
    (1, 1, 1, 260, 64, 512, 128),   # other chunks run alone
])
def test_mlstm_kernel_every_cluster_size_on_card(cluster, b, h, s, dk, dv, chunk):
    """Each cluster size the kernel may take, at a shape whose plan takes
    it (one wave, the column blocks allowing; chunk 64, the only chunk
    that shares its scores): the scores of a chunk split over the
    cluster's CTAs give the same h and state within the bound."""
    _skip_without_card()
    plan, _ = mlstm_launcher.kernel_plan(b * h, dk, dv, chunk)
    assert plan.cluster == cluster, plan
    _check_mlstm_on_card(b, h, s, dk, dv, chunk, normalize=cluster != 2)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,cluster", [(c, 1) for c in (16, 32, 128)]
                         + [(64, c) for c in (1, 2, 4, 8)])
def test_mlstm_score_tiles_are_owned_once_on_card(chunk, cluster):
    """The kernel's deal of a chunk's lower-triangular 16 x 8 score tiles
    (``score_tile`` in the source, the function the kernel calls): each
    is computed by exactly one warp of the cluster, on that warp's own
    row tile, within its ``score_slots`` (the instance's NS), and the
    busiest warp uses every slot; every score row i gets columns 0 .. i."""
    _skip_without_card()
    mt, warps = chunk // 16, mlstm_launcher.WARPS
    slots = mlstm_launcher.score_slots(chunk, cluster)
    owned, most = {}, 0
    for rank in range(cluster):
        for warp in range(warps):
            tiles = [mlstm_launcher.kernel_score_tile(chunk, cluster, rank, warp, i)
                     for i in range(slots)]
            assert mlstm_launcher.kernel_score_tile(chunk, cluster, rank, warp,
                                                    slots) == -2
            assert min(tiles) >= -1
            most = max(most, sum(j >= 0 for j in tiles))
            for j in tiles:
                if j >= 0:
                    owned[(warp % mt, j)] = owned.get((warp % mt, j), 0) + 1
    want = {(r, j) for r in range(mt) for j in range(2 * (r + 1))}
    assert set(owned) == want and set(owned.values()) == {1}
    assert most == slots
    for i in range(chunk):
        cols = {8 * j + c for (r, j) in owned if r == i // 16 for c in range(8)}
        assert set(range(i + 1)) <= cols
    if chunk != mlstm_launcher.SHARE_CHUNK:  # built for no cluster
        assert mlstm_launcher.kernel_score_tile(chunk, 2, 0, 0, 0) == -2


@pytest.mark.cuda
def test_mlstm_plan_and_smem_match_the_kernels_on_card():
    """The Python mirror of the kernel's plan (checked on the CPU by
    tests/test_torch_mlstm_plan.py) is the plan the built kernel makes
    with the card's cluster capacities; its grid takes no more waves than
    the cluster-free one; the shared memory the CPU tests use is the
    kernel's own."""
    _skip_without_card()
    for bh, dk, dv, chunk in ((32, 512, 512, 64), (8, 512, 512, 64),
                              (256, 512, 512, 64), (3, 64, 320, 64),
                              (2, 352, 128, 128), (4, 30, 50, 16),
                              (64, 672, 512, 64), (1, 1, 1, 16)):
        got, active = mlstm_launcher.kernel_plan(bh, dk, dv, chunk)
        assert got == mlstm_launcher.plan(bh, dk, dv, chunk, active), (bh, dk, dv)
        one = mlstm_launcher.plan(bh, dk, dv, chunk, active, cluster=1)
        assert got.waves <= one.waves
    for chunk in mlstm_launcher.TILES:
        for dk in (1, 17, 64, 256, 352, 353, 512, 672, 673, 832, 900):
            for cluster in mlstm_launcher.CLUSTERS:
                want = mlstm_launcher.smem_bytes(chunk, dk, cluster)
                got = mlstm_launcher.kernel_smem_bytes(chunk, dk, cluster)
                assert got == (want if want <= mlstm_launcher.MAX_SMEM_BYTES
                               else -1), (chunk, dk, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd", [(8, 4, 512, 256), (8, 4, 1, 256),
                                      (2, 4, 50, 8),
                                      (3, 2, 17, 100),  # 4 CTAs of 25 units
                                      (10, 4, 1, 256)])  # 3 rows a cluster
def test_slstm_kernel_from_a_state_matches_plain_on_card(b, h, s, hd):
    _skip_without_card()
    pre, r = _slstm_inputs(b, h, s, hd, seed=hd + s)
    rng = np.random.default_rng(s)
    c, n, m, hp = (rng.standard_normal((b, h, hd)).astype(np.float32) for _ in range(4))
    state = tuple(torch.from_numpy(x).cuda() for x in
                  (c, np.abs(n) + 1, 0.5 * m, np.tanh(hp)))
    before = slstm_launcher.launches
    got, fin = slstm_launcher.slstm_cell_cuda(pre, r, initial_state=state,
                                              return_state=True)
    want, wfin = slstm_cell_ref(pre, r, state, return_state=True)
    torch.cuda.synchronize()
    assert slstm_launcher.launches == before + 1
    for g, w in ((got, want), *zip(fin, wfin)):
        err = (g - w).abs()
        assert bool((err <= slstm_error_bound(w, g)).all()), float(err.max())
    # the zero-state call gives what it gave before the state existed
    zero = slstm_launcher.slstm_cell_cuda(pre, r)
    assert torch.equal(zero, slstm_launcher.slstm_cell_cuda(pre, r,
                                                            return_state=True)[0])


@pytest.mark.cuda
def test_serve_lm_on_card_launches_its_kernels():
    """The reduced xlstm through serve_lm on the card: one mLSTM and one
    sLSTM launch a layer pair in prefill, only the sLSTM in a decode
    step, and the card's logits agree with the CPU's."""
    _skip_without_card()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch import serve_lm
    from repro_torch.models import backbone as bb

    cfg = get_config("blendfl_paper")  # two pairs, d 256
    p = bb.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    counts = []

    def hook(stage, i):
        counts.append((stage, mlstm_launcher.launches, slstm_launcher.launches))

    start = (mlstm_launcher.launches, slstm_launcher.launches)
    res = serve_lm.generate(p, cfg, toks.cuda(), gen=3, max_len=64, hook=hook)
    deltas = [(s, m - pm, sl - ps) for (s, m, sl), (_, pm, ps) in
              zip(counts, [("", *start)] + counts[:-1])]
    assert deltas == [("prefill", 2, 2)] + [("decode", 0, 2)] * 3
    want = serve_lm.generate(params_from_numpy(params_to_numpy(p), "cpu"), cfg,
                             toks, gen=3, max_len=64)
    torch.testing.assert_close(res["logits"].cpu(), want["logits"], atol=1e-3,
                               rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name,flash,mlstm", [
    ("phi4_mini_3p8b", (2, 2), (0, 0)), ("hymba_1p5b", (2, 2), (2, 0)),
    ("whisper_medium", (6, 4), (0, 0)), ("qwen2_vl_2b", (2, 2), (0, 0)),
    ("deepseek_moe_16b", (2, 2), (0, 0)),
])
def test_serve_lm_families_on_card(name, flash, mlstm):
    """Each family reduced through serve_lm on the card: flash (and for
    hymba mLSTM) launches a prefill and a decode step, and the card's
    tokens and logits agree with the CPU's."""
    _skip_without_card()
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch import serve_lm
    from repro_torch.models import backbone as bb

    cfg = get_config(name).reduced()
    p = bb.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
    inputs = {}
    if cfg.frontend == "vision_stub":
        inputs["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.frontend_dim)).astype(np.float32))
    if cfg.is_encdec:
        inputs["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 40, cfg.frontend_dim)).astype(np.float32))
    counts = []

    def hook(stage, i):
        counts.append((flash_launcher.launches, mlstm_launcher.launches))

    start = (flash_launcher.launches, mlstm_launcher.launches)
    res = serve_lm.generate(p, cfg, toks.cuda(), gen=3, max_len=40, hook=hook,
                            inputs={k: v.cuda() for k, v in inputs.items()})
    deltas = [(f - pf, m - pm) for (f, m), (pf, pm) in zip(counts, [start] + counts[:-1])]
    assert deltas == [(flash[0], mlstm[0])] + [(flash[1], mlstm[1])] * 3
    want = serve_lm.generate(params_from_numpy(params_to_numpy(p), "cpu"), cfg,
                             toks, gen=3, max_len=40, inputs=inputs)
    torch.testing.assert_close(res["logits"].cpu(), want["logits"], atol=1e-3,
                               rtol=1e-3)


def _federation(*flags):
    from repro_torch.launch import train_federated as ttf

    return ttf.parse_args(["--clients", "6", "--n-train", "384", "--rows-cap",
                           "16", "--d-hidden", "16", "--n-val", "64",
                           "--log-every", "0", *flags])


@pytest.mark.cuda
def test_batcher_put_on_card_gives_the_host_batch():
    _skip_without_card()
    from repro_torch.launch import train_federated as ttf

    _, batcher, _, _ = ttf.build_federation(_federation("--n-sampled", "3",
                                                        "--device", "cuda"))
    host = batcher.build(0)
    dev = batcher.put(host)
    torch.cuda.synchronize()
    for k, v in host.items():
        assert dev[k].is_cuda and dev[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(dev[k].cpu().numpy(), v)
    np.testing.assert_array_equal(dev["val_a"].cpu().numpy(),
                                  batcher._val_host["val_a"])


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["--n-sampled", "3", "--codec", "int8_topk",
                                        "--optimizer", "sgd", "--lr", "0.1"]])
def test_sharded_round_on_card_matches_cpu(flags):
    """Two rounds of the sharded round on the card and on the CPU from the
    same state: losses rtol 1e-4, omegas atol 1e-3, params rtol 1e-4 /
    atol 1e-5 (the codec run's at the lossy run-level tolerance: all
    within 2e-2, 99% within 1e-5); one blend launch a group (A, B, M)
    and, under the codec, one codec launch a leaf each way."""
    _skip_without_card()
    from repro_torch.convert import round_state_to_numpy
    from repro_torch.launch import train_federated as ttf

    runs = {}
    for dev in ("cuda", "cpu"):
        args = _federation(*flags, "--device", dev)
        spec, batcher, round_fn, device = ttf.build_federation(args)
        _, state = ttf.init_or_restore(args, spec, device)
        rows = []
        for r in range(2):
            b0, c0 = blend_launcher.launches, launcher.launches
            state, m = round_fn(state, batcher.put(batcher.build(r)))
            rows.append(({k: v.cpu().numpy() for k, v in m.items()},
                         blend_launcher.launches - b0, launcher.launches - c0))
        runs[dev] = (rows, round_state_to_numpy(state))
    n_leaves = len(tree_leaves(runs["cpu"][1]["global_models"]))
    for (card, nb, nc), (cpu, _, _) in zip(runs["cuda"][0], runs["cpu"][0]):
        assert nb == 3 and nc == (2 * n_leaves if flags else 0)
        for k in ("loss_uni", "loss_vfl", "loss_paired"):
            np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4)
        for k in ("omega_A", "omega_B", "omega_M"):
            np.testing.assert_allclose(card[k], cpu[k], atol=1e-3)
    a = tree_leaves(runs["cuda"][1]["global_models"])
    b = tree_leaves(runs["cpu"][1]["global_models"])
    if flags:
        d = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
        assert d.max() <= 2e-2 and (d <= 1e-5).mean() >= 0.99
    else:
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)
    for k in ("part_count", "last_round"):
        np.testing.assert_array_equal(runs["cuda"][1]["sched"][k],
                                      runs["cpu"][1]["sched"][k])


# ----------------------------------------------------------- baselines --

@pytest.mark.cuda
def test_fedma_matcher_on_card_equals_cpu():
    """FedMA's greedy matcher at a full-width hidden layer (n = 1024):
    the picks on the card (argmax over a masked copy of sim) equal the
    CPU's exactly, on a random pair and on one laden with ties."""
    _skip_without_card()
    from repro_torch.core.baselines import _greedy_match

    rng = np.random.default_rng(11)
    ref = rng.standard_normal((1024, 1024)).astype(np.float32)
    cand = (ref[rng.permutation(1024)]
            + 0.5 * rng.standard_normal((1024, 1024))).astype(np.float32)
    tied = cand.copy()
    tied[1::2] = tied[::2]
    tied[:128] = 0
    for c in (cand, tied):
        got = _greedy_match(ref.T, c.T, device="cuda")
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _greedy_match(ref.T, c.T, device="cpu").numpy())


@pytest.mark.cuda
def test_fedavg_round_launches_its_blends_on_card():
    """One FedAvg round on the card blends through the kernel: one launch
    a model tree it blends (f_A, g_A, f_B, g_B and g_M, each of a group
    that has members)."""
    _skip_without_card()
    from repro_torch.core.baselines import run_fedavg
    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.core.federation import FedConfig
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import make_task, train_val_test

    spec = make_task("smnist")
    tr, va, te = train_val_test(spec, 300, 200, 200, seed=0)
    clients = partition(tr, 3, seed=1)
    ecfg = EncoderConfig(d_hidden=32, n_layers=2)
    cfg = FedConfig(n_clients=3, rounds=1, lr=1e-2, batch_size=64)
    trees = {"A": 2, "B": 2, "M": 1}  # f_A and g_A; f_B and g_B; g_M
    want = sum(trees[m] for m, has in (("A", "has_a"), ("B", "has_b"),
                                       ("M", "has_paired"))
               if any(getattr(c, has) for c in clients))
    before = blend_launcher.launches
    res, _ = run_fedavg(torch.Generator().manual_seed(0), spec, ecfg, clients,
                        va, te, cfg, device="cuda")
    assert blend_launcher.launches - before == want == 5
    assert all(np.isnan(v) or 0.0 <= v <= 1.0 for v in res.values())


# -------------------------------------------- backward kernels (training) --
# The sLSTM forward's stacked and saving forms against the plain form of
# the same kernel: bit for bit (the arithmetic of a (row, gate) does not
# depend on the plan). The backward kernels against their plain backwards
# on the same saved inputs: within slstm_grad_error_bound /
# flash_grad_error_bound (GRAD_RTOL of each entry plus GRAD_ATOL_REL of
# the tensor's largest).

def _stacked_slstm(c, b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((c * b, h, s, 4, hd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((c, h, hd, 4 * hd)) / np.sqrt(hd)).astype(np.float32)
    return torch.from_numpy(pre).cuda(), torch.from_numpy(r).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h,s,hd", [
    (1, 2, 4, 64, 256), (3, 5, 2, 17, 16), (16, 4, 4, 8, 256), (2, 40, 2, 9, 8),
])
def test_slstm_stacked_and_saving_forward_bit_for_bit_on_card(c, b, h, s, hd):
    """One launch for C clients gives each client's rows what a launch of
    that client alone gives; saving changes nothing; with C = 1 the
    stacked form is the unstacked call."""
    _skip_without_card()
    from repro_torch.kernels.slstm_cell.ref import slstm_cell_ref as ref

    pre, r = _stacked_slstm(c, b, h, s, hd, seed=c + hd)
    before = slstm_launcher.launches
    out, saved = slstm_launcher.slstm_cell_cuda(pre, r, save=True)
    assert slstm_launcher.launches == before + 1
    assert torch.equal(out, slstm_launcher.slstm_cell_cuda(pre, r))
    for k in range(c):
        alone = slstm_launcher.slstm_cell_cuda(pre[k * b:(k + 1) * b].contiguous(),
                                               r[k].contiguous())
        assert torch.equal(out[k * b:(k + 1) * b], alone), k
    want_out, want_saved = ref(pre, r, save=True)
    err = (saved - want_saved).abs()
    assert bool((err <= slstm_error_bound(want_saved, saved)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h,s,hd", [
    (1, 2, 4, 64, 256), (1, 64, 4, 64, 256), (3, 5, 2, 17, 16),
    (2, 40, 2, 9, 8), (4, 3, 4, 33, 64),
    # one and sixteen clients; rows that are not a multiple of the
    # cluster's rows (37 = 32 + 5, 70 = 2 x 32 + 6 at one client); hd 4,
    # 64 and 256 (clusters of 1, 2 and 8)
    (1, 37, 4, 12, 256), (1, 70, 2, 5, 64), (16, 64, 4, 16, 256),
    (16, 3, 2, 7, 4), (1, 33, 1, 9, 4), (16, 11, 4, 6, 64),
    # an odd number of units a CTA (4-byte sends): hd 100 (4 x 25), 68
    # (4 x 17), 196 (8 x 25)
    (1, 37, 2, 9, 100), (2, 5, 1, 7, 68), (16, 6, 4, 5, 196),
])
def test_slstm_bwd_kernel_matches_plain_on_card(c, b, h, s, hd):
    """The BPTT kernel against the plain backward on the kernel's own
    saved forward; one launch."""
    _skip_without_card()
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as bwd
    from repro_torch.kernels.slstm_cell.ref import (slstm_cell_bwd_ref,
                                                    slstm_grad_error_bound)

    pre, r = _stacked_slstm(c, b, h, s, hd, seed=7 * c + hd)
    _, saved = slstm_launcher.slstm_cell_cuda(pre, r, save=True)
    dhs = torch.randn(c * b, h, s, hd, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(hd))
    before = bwd.launches
    got = bwd.slstm_cell_bwd_cuda(saved, r, dhs)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    want = slstm_cell_bwd_ref(saved, r, dhs)
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= slstm_grad_error_bound(want)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h,s,hd,repeats", [
    (16, 64, 4, 64, 256, 200),  # a full-width round's stacked application
    (1, 37, 4, 12, 256, 1000), (1, 37, 2, 9, 100, 1000),
    (2, 5, 1, 7, 68, 1000), (16, 3, 2, 7, 4, 1000),
])
def test_slstm_bwd_kernel_repeats_bit_for_bit_on_card(c, b, h, s, hd, repeats):
    """The BPTT kernel's exchange (st.async into per-source slots, counted
    on mbarriers by parity) sums in a fixed order: launched many times on
    the same inputs, it gives the same bits every time. A race would show
    as a differing launch, a lost message as a trapped one (bar_wait)."""
    _skip_without_card()
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as bwd

    pre, r = _stacked_slstm(c, b, h, s, hd, seed=11 * c + hd)
    _, saved = slstm_launcher.slstm_cell_cuda(pre, r, save=True)
    dhs = torch.randn(c * b, h, s, hd, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(hd))
    first = bwd.slstm_cell_bwd_cuda(saved, r, dhs)
    before = bwd.launches
    differ = [i for i in range(repeats)
              if not torch.equal(bwd.slstm_cell_bwd_cuda(saved, r, dhs), first)]
    assert bwd.launches == before + repeats
    assert differ == []


@pytest.mark.cuda
def test_slstm_autograd_on_card_matches_cpu():
    """SLSTMCellFn on the card (both kernels) against its CPU path (the
    plain versions) on the same inputs: the forward and pre_x's and r's
    gradients."""
    _skip_without_card()
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as bwd
    from repro_torch.kernels.slstm_cell.ops import slstm_cell
    from repro_torch.kernels.slstm_cell.ref import slstm_grad_error_bound

    pre, r = _stacked_slstm(2, 6, 2, 12, 16, seed=3)
    w = torch.randn(12, 2, 12, 16, generator=torch.Generator().manual_seed(0))
    grads = []
    for dev in ("cuda", "cpu"):
        p = pre.detach().to(dev).requires_grad_(True)
        rr = r.detach().to(dev).requires_grad_(True)
        out = slstm_cell(p, rr)
        (out * w.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), p.grad.cpu(), rr.grad.cpu()))
    before = bwd.launches
    slstm_cell(pre.clone().requires_grad_(True), r).sum().backward()
    assert bwd.launches == before + 1
    (o1, g1, d1), (o0, g0, d0) = grads
    assert bool(((o1 - o0).abs() <= slstm_error_bound(o0, o1)).all())
    for got, want in ((g1, g0), (d1, d0)):
        assert bool(((got - want).abs() <= slstm_grad_error_bound(want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 4, 64, 64, 256, False), (3, 2, 64, 64, 16, False),
    (1, 2, 40, 72, 32, True), (2, 2, 70, 70, 64, False), (1, 1, 5, 3, 8, True),
    # the fused kernel (Sq, Sk <= 64) at S 13 and 64, d 16, 64 and 256
    (2, 3, 13, 13, 16, False), (3, 2, 13, 13, 256, True),
    (2, 2, 64, 64, 64, True), (1, 4, 13, 64, 64, False),
    # the two-kernel path at S = 65, causal
    (2, 2, 65, 65, 64, True), (1, 2, 65, 65, 256, True),
])
def test_flash_lse_and_bwd_kernel_match_plain_on_card(b, h, sq, sk, d, causal):
    """The forward's log-sum-exp leaves its output as it was, bit for
    bit, and matches the plain version's; the backward kernels match the
    plain backward on the same inputs, in the launches the shape rule
    gives (one fused kernel where Sq, Sk <= 64, else two)."""
    _skip_without_card()
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_grad_error_bound)

    q, k, v = _qkv(b, h, h, sq, sk, d, seed=d + sq)
    out, lse = flash_launcher.flash_attention_cuda(q, k, v, causal=causal,
                                                   window=0, return_lse=True)
    assert torch.equal(out, flash_launcher.flash_attention_cuda(
        q, k, v, causal=causal, window=0))
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    np.testing.assert_allclose(lse[fin].cpu().numpy(), want_lse[fin].cpu().numpy(),
                               rtol=FLASH_TOL[torch.float32],
                               atol=FLASH_TOL[torch.float32])
    dout = torch.randn_like(out)
    before = fbwd.launches
    got = fbwd.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal)
    torch.cuda.synchronize()
    assert fbwd.launches == before + fbwd.kernels_a_call(sq, sk)
    assert fbwd.kernels_a_call(sq, sk) == (1 if max(sq, sk) <= 64 else 2)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g - w).abs()
        assert bool((err <= flash_grad_error_bound(w)).all()), (name, float(err.max()))


# The language models' forms of the flash backward: (B, Hq, Hkv, Sq, Sk,
# d, causal, window, softcap). Grouped K/V heads at G = 3, 5, 9 (the
# two-kernel path at any length), windows that bind inside and across
# tiles, the logit cap (both paths' capped instances), d = 80 (the KD =
# 128 instance), queries end-aligned to fewer keys (rows with no visible
# key) and to more (cross attention).
FLASH_BWD_FORMS = [
    (2, 6, 2, 100, 100, 64, True, 0, 0.0),
    (1, 10, 2, 130, 130, 64, True, 40, 0.0),
    (2, 4, 4, 150, 150, 32, True, 33, 0.0),
    (1, 4, 4, 48, 48, 16, True, 16, 0.0),
    (2, 4, 4, 48, 48, 16, True, 0, 30.0),
    (1, 6, 2, 90, 90, 80, True, 0, 20.0),
    (2, 9, 1, 40, 40, 16, True, 0, 0.0),
    (1, 4, 2, 70, 130, 64, False, 0, 0.0),
    (1, 4, 2, 130, 70, 64, True, 24, 5.0),
    (1, 2, 2, 200, 200, 128, True, 64, 50.0),
]


def _flash_bwd_inputs(b, hq, hkv, sq, sk, d, causal, window, softcap, seed):
    """q, k, v, the forward kernel's output and lse at this form, and a
    random output gradient."""
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=seed)
    out, lse = flash_launcher.flash_attention_cuda(
        q, k, v, causal=causal, window=window, softcap=softcap, return_lse=True)
    dout = torch.randn(out.shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))
    return q, k, v, out, dout, lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", FLASH_BWD_FORMS)
def test_flash_bwd_forms_match_plain_on_card(b, hq, hkv, sq, sk, d, causal,
                                             window, softcap):
    """Every form the forward takes, through the backward kernels: the
    forward's lse against the plain version's, then dq, dk and dv within
    flash_grad_error_bound of the plain backward on the same inputs, in
    kernels_a_call(Sq, Sk, G) launches."""
    _skip_without_card()
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_grad_error_bound)

    form = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, out, dout, lse = _flash_bwd_inputs(b, hq, hkv, sq, sk, d, **form,
                                                seed=sq + d + hq)
    _, want_lse = flash_attention_ref(q, k, v, return_lse=True, **form)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    np.testing.assert_allclose(lse[fin].cpu().numpy(), want_lse[fin].cpu().numpy(),
                               rtol=FLASH_TOL[torch.float32],
                               atol=FLASH_TOL[torch.float32])
    before = fbwd.launches
    got = fbwd.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **form)
    torch.cuda.synchronize()
    assert fbwd.launches == before + fbwd.kernels_a_call(sq, sk, hq // hkv)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, **form)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        err = (g - w).abs()
        assert bool((err <= flash_grad_error_bound(w)).all()), (name, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", [
    (2, 6, 2, 100, 100, 64, True, 0, 0.0), (1, 4, 4, 48, 48, 16, True, 16, 30.0),
    (1, 10, 2, 130, 130, 64, True, 40, 5.0),
])
def test_flash_autograd_launches_on_card(b, hq, hkv, sq, sk, d, causal, window,
                                         softcap):
    """Through ``flash_attention`` under autograd (FlashAttentionFn): one
    forward launch, then kernels_a_call(Sq, Sk, G) backward launches and
    the plain backward's gradients; 1 launch only where Sq, Sk <= 64 and
    G = 1."""
    _skip_without_card()
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_grad_error_bound)

    form = dict(causal=causal, window=window, softcap=softcap)
    xs = [x.requires_grad_() for x in _qkv(b, hq, hkv, sq, sk, d, seed=7)]
    f0, b0 = flash_launcher.launches, fbwd.launches
    out = flash_attention(*xs, **form)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    dout = torch.randn_like(out)
    out.backward(dout)
    torch.cuda.synchronize()
    n = fbwd.kernels_a_call(sq, sk, hq // hkv)
    assert n == (1 if max(sq, sk) <= 64 and hq == hkv else 2)
    assert (flash_launcher.launches, fbwd.launches) == (f0 + 1, b0 + n)
    q, k, v = (x.detach() for x in xs)
    _, lse = flash_attention_ref(q, k, v, return_lse=True, **form)
    want = flash_attention_bwd_ref(q, k, v, out.detach(), dout, lse, **form)
    for x, w in zip(xs, want):
        assert bool(((x.grad - w).abs() <= flash_grad_error_bound(w)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", [
    (1, 10, 2, 130, 130, 64, True, 40, 0.0), (2, 4, 4, 48, 48, 16, True, 0, 30.0),
    (1, 6, 2, 90, 90, 80, True, 0, 20.0),
])
def test_flash_bwd_is_deterministic_on_card(b, hq, hkv, sq, sk, d, causal, window,
                                            softcap):
    """No float atomics: calls on the same inputs give the same bits (dk
    and dv summed over a K/V head's query heads in registers, in order)."""
    _skip_without_card()
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd

    form = dict(causal=causal, window=window, softcap=softcap)
    xs = _flash_bwd_inputs(b, hq, hkv, sq, sk, d, **form, seed=3)
    first = fbwd.flash_attention_bwd_cuda(*xs, **form)
    for _ in range(20):
        again = fbwd.flash_attention_bwd_cuda(*xs, **form)
        assert all(torch.equal(a, g) for a, g in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_heads,hd", [
    (64, 64, 256), (64, 4, 256), (2, 4, 256), (37, 4, 256), (3, 32, 4),
    (11, 64, 64), (1000, 1, 100),
])
def test_slstm_bwd_plan_matches_the_kernel_on_card(b, n_heads, hd):
    """The backward kernel's plan is slstm_cell_bwd.plan at the budget the
    card gives, and the card holds at least one of its clusters."""
    _skip_without_card()
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as bwd

    got, budget, active = bwd.kernel_plan(b, n_heads, hd)
    assert got == bwd.plan(b, n_heads, hd, budget)
    assert budget >= 1 and active >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dk,dv,normalize", [
    (1, 2, 150, 64, 64, True),     # two chunks and a ragged tail
    (1, 2, 150, 64, 64, False),
    (2, 3, 37, 16, 24, True),      # one ragged chunk, dv + 1 < 64 columns
    (2, 4, 128, 512, 512, True),   # xlstm-350m's heads (dv + 1 = 513: 17 tiles)
    (2, 25, 256, 16, 64, False),   # hymba's Mamba heads
    (1, 1, 70, 8, 130, True),      # three column blocks, the last ragged
    (2, 25, 2048, 16, 64, False),  # hymba's S: 32 chunks in parallel, 31 states
    (1, 1, 130, 1024, 64, True),   # dk 1024 with the normalizer: 16 state row tiles
    (1, 2, 40, 24, 100, True),     # one chunk (no state), 2 state row tiles of 16
    (1, 1, 300, 40, 200, False),   # 5 chunks, 4 state column tiles, dv past dk
    (2, 1, 200, 33, 31, True),     # state row tiles of 32, odd widths (no cp.async)
    (1, 2, 4500, 16, 32, False),   # 71 chunks: the states' pass past 64 updates
])
def test_mlstm_bwd_kernel_matches_plain_on_card(b, h, s, dk, dv, normalize):
    """The backward kernel's dq, dk, dv and dlog_f within
    mlstm_grad_error_bound of the plain backward on the same inputs, h
    among them (1e-5 plus 1e-4 of the row's largest |gradient|; for dq,
    of its row's largest summand), one launch counted a call; a repeat
    gives the same bits (no atomics)."""
    _skip_without_card()
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as bwd
    from repro_torch.kernels.mlstm_scan.ref import (mlstm_grad_error_bound,
                                                    mlstm_scan_bwd_ref)

    q, k, v, lf = _mlstm_inputs(b, h, s, dk, dv, seed=s + dk + dv)
    dh = torch.randn(b, h, s, dv, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(s))
    out = mlstm_scan_ref(q, k, v, lf, normalize=normalize)
    before = bwd.launches
    got = bwd.mlstm_scan_bwd_cuda(q, k, v, lf, out, dh, normalize=normalize)
    again = bwd.mlstm_scan_bwd_cuda(q, k, v, lf, out, dh, normalize=normalize)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    want, dq_scale = mlstm_scan_bwd_ref(q, k, v, lf, dh, h=out, normalize=normalize,
                                        dq_scale=True)
    for name, g, a, w in zip(("dq", "dk", "dv", "dlog_f"), got, again, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert torch.equal(g, a), name
        err = (g - w).abs()
        bound = mlstm_grad_error_bound(w, dq_scale if name == "dq" else None)
        assert bool((err <= bound).all()), (name, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,dk,dv,normalize", [
    (32, 128, 512, 512, True), (50, 2048, 16, 64, False), (2, 150, 64, 64, True),
    (6, 37, 16, 24, True), (1, 70, 8, 130, True), (1, 130, 1024, 64, True),
    (3, 64, 100, 1, False), (1, 1, 1, 1, True),
])
def test_mlstm_bwd_plan_matches_the_kernel_on_card(bh, s, dk, dv, normalize):
    """The backward kernels' grids, scratch and shared memory are those of
    the launcher's mirror (mlstm_scan_bwd.plan, work_bytes, CHUNK_SMEM,
    checked on the CPU by tests/test_torch_mlstm_bwd_plan.py), and the
    card holds at least one CTA of each kernel an SM."""
    _skip_without_card()
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as bwd

    got, per_sm, smem = bwd.kernel_plan(bh, s, dk, dv, normalize)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert got == bwd.plan(bh, s, dk, dv, normalize, sms=sms, per_sm=per_sm)
    assert all(n >= 1 for n in per_sm.values()), per_sm
    assert smem == {"state": bwd.STATE_SMEM, "scores": bwd.SCORE_SMEM,
                    "chunk": bwd.CHUNK_SMEM,
                    "launches": bwd.LAUNCHES}
    assert bwd.kernel_work_bytes(bh, s, dk, dv, normalize) == bwd.work_bytes(
        bh, s, dk, dv, normalize)


@pytest.mark.cuda
def test_mlstm_scan_with_grad_on_card_has_grad_fn():
    """Fault (m): a CUDA scan that wants a gradient goes through
    MLSTMScanFn (the forward and backward kernels, one launch each) and
    its gradients match the plain backward's; what the backward does not
    take refuses: a final state with a gradient, naming ROADMAP item
    15c-2, and a half input (bf16 trains since item 15c-1:
    ``test_mlstm_scan_bf16_gradients_on_card``)."""
    _skip_without_card()
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as bwd
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.kernels.mlstm_scan.ref import (mlstm_grad_error_bound,
                                                    mlstm_scan_bwd_ref)

    q, k, v, lf = _mlstm_inputs(2, 2, 100, 32, 32, seed=11)
    xs = [x.clone().requires_grad_() for x in (q, k, v, lf)]
    f0, b0 = mlstm_launcher.launches, bwd.launches
    out = mlstm_scan(*xs)
    assert out.grad_fn is not None and "MLSTMScanFn" in type(out.grad_fn).__name__
    w = torch.randn_like(out)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (mlstm_launcher.launches, bwd.launches) == (f0 + 1, b0 + 1)
    want, dq_scale = mlstm_scan_bwd_ref(q, k, v, lf, w, h=out.detach(),
                                        dq_scale=True)
    for i, (x, g) in enumerate(zip(xs, want)):
        err = (x.grad - g).abs()
        bound = mlstm_grad_error_bound(g, dq_scale if i == 0 else None)
        assert bool((err <= bound).all()), float(err.max())
    with pytest.raises(NotImplementedError, match="item 15c-2"):
        mlstm_scan(*xs, return_state=True)
    with pytest.raises(NotImplementedError, match="item 15c"):
        mlstm_scan(*[x.detach().half().requires_grad_() for x in xs])


# ------------------------------------- bf16 training (ROADMAP item 15c-1) --

BF16_TRAIN_FORMS = [  # (b, hq, hkv, sq, sk, d, causal, window, softcap)
    (2, 10, 2, 160, 160, 64, True, 48, 0.0),  # GQA with a window
    (2, 4, 4, 96, 75, 64, False, 0, 0.0),  # cross attention, Sq != Sk
    (1, 6, 2, 130, 130, 128, True, 0, 30.0),  # GQA, a logit cap
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", BF16_TRAIN_FORMS)
def test_flash_bf16_with_lse_on_card(b, hq, hkv, sq, sk, d, causal, window, softcap):
    """The bf16 forward with its log-sum-exp: the output equals the bf16
    instance's without it bit for bit (the serving path), and the lse the
    plain version's (f32 from the same bf16 inputs) within the f32
    tolerance; the output within ``bf16_error_bound``."""
    _skip_without_card()
    form = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=sq + hq, dtype=torch.bfloat16)
    out, lse = flash_launcher.flash_attention_cuda(q, k, v, return_lse=True, **form)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, flash_launcher.flash_attention_cuda(q, k, v, **form))
    want, want_lse = flash_attention_ref(q, k, v, return_lse=True, **form)
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    np.testing.assert_allclose(lse[fin].cpu().numpy(), want_lse[fin].cpu().numpy(),
                               rtol=FLASH_TOL[torch.float32],
                               atol=FLASH_TOL[torch.float32])
    err = (out.float() - want.float()).abs()
    assert bool((err <= flash_bf16_error_bound(q, k, v, out, want, **form)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", BF16_TRAIN_FORMS)
def test_flash_autograd_bf16_on_card(b, hq, hkv, sq, sk, d, causal, window, softcap):
    """``FlashAttentionFn`` on bf16 q, k, v: one bf16 forward launch, the
    backward kernels on the inputs cast up (kernels_a_call launches), and
    bf16 gradients: the plain backward's on the same upcast inputs and
    the forward's lse, within ``flash_grad_error_bound`` before the
    bf16 rounding (plus one bf16 ulp of the gradient after it)."""
    _skip_without_card()
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels import bf16_ulp
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_grad_error_bound)

    form = dict(causal=causal, window=window, softcap=softcap)
    xs = [x.requires_grad_() for x in _qkv(b, hq, hkv, sq, sk, d, seed=5,
                                           dtype=torch.bfloat16)]
    f0, b0 = flash_launcher.launches, fbwd.launches
    out = flash_attention(*xs, **form)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    dout = torch.randn(out.shape, device="cuda").to(torch.bfloat16)
    out.backward(dout)
    torch.cuda.synchronize()
    n = fbwd.kernels_a_call(sq, sk, hq // hkv)
    assert (flash_launcher.launches, fbwd.launches) == (f0 + 1, b0 + n)
    q, k, v = (x.detach() for x in xs)
    _, lse = flash_launcher.flash_attention_cuda(q, k, v, return_lse=True, **form)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   out.detach().float(), dout.float(), lse, **form)
    for x, w in zip(xs, want):
        assert x.grad.dtype == torch.bfloat16
        got = x.grad.float()
        bound = flash_grad_error_bound(w) + bf16_ulp(torch.maximum(got.abs(), w.abs()))
        assert bool(((got - w).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
def test_mlstm_scan_bf16_gradients_on_card(normalize):
    """bf16 q, k, v through ``mlstm_scan`` under autograd: cast up to f32
    before ``MLSTMScanFn`` (one forward launch, one backward call), the
    gradients returned in bf16: the plain backward's on the upcast inputs
    (fed the kernel's h) within ``mlstm_grad_error_bound``, plus one bf16
    ulp; log_f's, f32, within the bound."""
    _skip_without_card()
    from repro_torch.kernels import bf16_ulp
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as bwd
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.kernels.mlstm_scan.ref import (mlstm_grad_error_bound,
                                                    mlstm_scan_bwd_ref)

    q, k, v, lf = _mlstm_inputs(2, 3, 150, 32, 48, seed=13)
    xs = [x.to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    lf = lf.clone().requires_grad_()
    f0, b0 = mlstm_launcher.launches, bwd.launches
    out = mlstm_scan(*xs, lf, normalize=normalize)
    assert out.dtype == torch.float32
    w = torch.randn(out.shape, device="cuda")
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (mlstm_launcher.launches, bwd.launches) == (f0 + 1, b0 + 1)
    up = [x.detach().float() for x in xs]
    want, dq_scale = mlstm_scan_bwd_ref(*up, lf.detach(), w, h=out.detach(),
                                        normalize=normalize, dq_scale=True)
    for i, (x, g) in enumerate(zip(xs + [lf], want)):
        got = x.grad.float()
        bound = mlstm_grad_error_bound(g, dq_scale if i == 0 else None)
        if i < 3:
            assert x.grad.dtype == torch.bfloat16
            bound = bound + bf16_ulp(torch.maximum(got.abs(), g.abs()))
        assert bool(((got - g).abs() <= bound).all()), i
