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
plus one bf16 ulp for bf16. The sLSTM kernel's recurrent products sum in
another order than the plain version's: within ``slstm_error_bound``
(atol 1e-5, rtol 1e-4, plus one bf16 ulp for bf16). Flash attention
against its plain version: 2e-5 in f32 and 2e-2 in bf16, the reference's
kernel-test tolerances. The mLSTM scan's h and final (C, n) against the
step recurrence: within ``mlstm_error_bound`` (atol 1e-5 plus 1e-4 of the
row's largest value: dot products of dk terms summed in another order,
the decay factored per chunk). The sLSTM from a running state: output
and final state within ``slstm_error_bound``. The reduced xlstm through
``serve_lm`` on the card against the CPU: logits within 1e-3.
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
    within 2e-2, 99% within 1e-5); one blend launch a leaf of each group
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
        assert nb == n_leaves and nc == (2 * n_leaves if flags else 0)
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
    a leaf of each model group that has members (f_A + g_A, f_B + g_B,
    g_M)."""
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
    leaves = {"A": 2 + 2 * 2 + 1 + 2, "B": 2 + 2 * 2 + 1 + 2, "M": 4}
    want = sum(leaves[m] for m, has in (("A", "has_a"), ("B", "has_b"),
                                        ("M", "has_paired"))
               if any(getattr(c, has) for c in clients))
    before = blend_launcher.launches
    res, _ = run_fedavg(torch.Generator().manual_seed(0), spec, ecfg, clients,
                        va, te, cfg, device="cuda")
    assert blend_launcher.launches - before == want == 22
    assert all(np.isnan(v) or 0.0 <= v <= 1.0 for v in res.values())
