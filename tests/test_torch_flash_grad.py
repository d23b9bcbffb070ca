"""The attention gradient in the PyTorch port (``FlashAttentionFn``, its
CPU path: the plain forward with its row log-sum-exp, then the plain
backward) against ``jax.grad`` of the reference's forms on the same numpy
inputs: the einsum softmax of ``src/repro/core/encoders.py`` alone, the
whole transformer encoder (``encoder_apply``) from the reference's
initial weights, and the language models' ``gqa_sdpa`` and
``chunked_gqa_sdpa`` (``src/repro/models/attention.py``) in every form
they take: grouped K/V heads (G = 1, 3, 5, 9), causal and sliding-window
masks (a window of 16 at 48 tokens), the logit cap (30), queries
end-aligned to more keys, head dims 16 and 80.

Tolerance: rtol 1e-4, atol 1e-5 (f32 on the CPU). The port's scale is
``1 / sqrt(hd)`` in f32 and the reference's a division by ``sqrt(hd)``:
equal at 16 and 64 (powers of 4, ROADMAP fault (e)), an ulp apart at 80.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as jenc
from repro.models import attention as jatt
from repro_torch.convert import params_from_numpy
from repro_torch.core import encoders as tenc
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                          (b, h, sq, d))]


@pytest.mark.parametrize("b,h,s,d", [(2, 2, 8, 16), (1, 4, 13, 16), (3, 1, 5, 64)])
def test_attention_grads_match_jax(b, h, s, d):
    """FlashAttentionFn (non-causal, the encoder's) against jax.grad of
    the reference's softmax(q k^T / sqrt(d)) v."""
    q, k, v, w = _qkv(b, h, s, s, d, seed=s * d)

    def jatt(q, k, v):
        att = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(d),
                             axis=-1)
        return jnp.sum(jnp.einsum("bhqk,bhkd->bhqd", att, v) * w)

    want = jax.grad(jatt, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    torch.sum(flash_attention(*ts, causal=False) * torch.from_numpy(w)).backward()
    for name, t, g in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **TOL)
    assert flash_attention_bwd.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 2, 8, 8, 16, False), (1, 3, 9, 9, 8, True), (2, 1, 4, 7, 12, True),
    (1, 2, 7, 3, 4, True),
])
def test_plain_backward_matches_autograd_of_plain_forward(b, h, sq, sk, d, causal):
    """flash_attention_bwd_ref from the forward's lse against float64
    autograd of the plain forward, causal (queries end-aligned, and rows
    with no visible key, which give 0) and not."""
    q, k, v, w = (torch.from_numpy(x).double() for x in _qkv(b, h, sq, sk, d, seed=d))
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    torch.sum(flash_attention_ref(*ts, causal=causal) * w).backward()
    out, lse = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                   return_lse=True)
    got = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out, w.float(),
                                  lse, causal=causal)
    for name, t, g in zip("qkv", ts, got):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("d,heads", [(32, 2), (64, 4)])
def test_transformer_encoder_grads_match_jax(d, heads):
    """The transformer encoder's parameter and input gradients against
    jax.grad of the reference's ``encoder_apply``, from the reference's
    initial weights (whose key reuse, wk == wv == ff.w, is kept: fault
    (e)) plus numpy noise."""
    rng = np.random.default_rng(d)
    jcfg = jenc.EncoderConfig(d_hidden=d, n_layers=1, enc_type="transformer",
                              n_heads=heads)
    tcfg = tenc.EncoderConfig(d_hidden=d, n_layers=1, enc_type="transformer",
                              n_heads=heads)
    p = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape)).astype(np.float32), jenc.encoder_init(jax.random.PRNGKey(3), 12, jcfg))
    x = rng.standard_normal((3, 6, 12)).astype(np.float32)
    w = rng.standard_normal((3, d)).astype(np.float32)
    want_p, want_x = jax.grad(
        lambda p, x: jnp.sum(jenc.encoder_apply(p, x, jcfg) * w), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = params_from_numpy(p, "cpu")
    leaves, treedef = jax.tree.flatten(tp)
    leaves = [t.requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = jax.tree.unflatten(treedef, leaves)
    torch.sum(tenc.encoder_apply(tp, tx, tcfg) * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    jax.tree.map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), **TOL), tp, want_p)


def test_refusals_under_autograd():
    """Grouped K/V heads, a window and a logit cap train (ROADMAP item
    15b), in f32 and, since item 15c-1, in bf16: the gradients come back
    in bf16, the plain backward's f32 gradients cast down. A half or a
    double input with a gradient refuses, naming item 15c; a K/V dtype
    other than q's too. Without a gradient bf16 runs."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
            for _ in range(2))
    k4 = torch.zeros((1, 4, 5, 8))
    for dtype in (torch.float32, torch.bfloat16):
        xs = [x.to(dtype).requires_grad_(True) for x in (q, k, v)]
        for form in (dict(), dict(window=2), dict(softcap=5.0),
                     dict(window=2, softcap=5.0)):
            out = flash_attention(*xs, causal=True, **form)  # GQA
            assert "FlashAttentionFn" in type(out.grad_fn).__name__
            assert out.dtype == dtype
            grads = torch.autograd.grad(out.sum(), xs)
            assert [g.shape for g in grads] == [x.shape for x in xs]
            assert all(g.dtype == dtype for g in grads)
            if dtype == torch.bfloat16:  # the f32 backward, cast down
                o, lse = flash_attention_ref(*(x.detach() for x in xs),
                                             return_lse=True, causal=True, **form)
                want = flash_attention_bwd_ref(*(x.detach() for x in xs), o,
                                               torch.ones_like(o), lse, causal=True,
                                               **form)
                assert all(torch.equal(g, w.bfloat16()) for g, w in zip(grads, want))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="item 15c"):
            flash_attention(q.to(dtype).requires_grad_(True), k4.to(dtype),
                            k4.to(dtype), causal=True)
    with pytest.raises(NotImplementedError, match="item 15c"):
        flash_attention(q.bfloat16().requires_grad_(True), k4, k4, causal=True)
    with torch.no_grad():
        assert flash_attention(q.bfloat16(), k4.bfloat16(), k4.bfloat16(),
                               causal=True, window=2).shape == q.shape


def test_bwd_launcher_refuses_cpu_tensors():
    """No silent fallback: the backward kernels' launcher raises on CPU
    tensors before it builds or launches anything."""
    q = torch.zeros(1, 2, 5, 8)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, q, q, q, q,
                                                     torch.zeros(1, 2, 5),
                                                     causal=False)
    assert flash_attention_bwd.launches == before


@pytest.mark.parametrize("sq,sk,want", [
    (64, 64, 1), (1, 1, 1), (13, 64, 1), (64, 13, 1),  # one tile: the fused kernel
    (65, 64, 2), (64, 65, 2), (65, 65, 2), (1024, 1024, 2),  # dq, then dk and dv
])
def test_launches_a_call_follow_the_shape(sq, sk, want):
    """The backward launches one fused kernel where the (batch, head) is a
    single 64 x 64 tile, else two; by shape alone, never as a fallback."""
    assert flash_attention_bwd.kernels_a_call(sq, sk) == want


@pytest.mark.parametrize("sq,sk,group,want", [
    (64, 64, 2, 2), (13, 13, 5, 2), (1, 1, 9, 2), (64, 64, 1, 1), (48, 20, 1, 1),
    (1024, 1024, 1, 2), (2048, 2048, 5, 2),
])
def test_launches_a_call_follow_shape_and_group(sq, sk, group, want):
    """Grouped K/V heads take the two-kernel path at any length (dk and dv
    summed over a K/V head's query heads in the dk/dv kernel); the fused
    kernel only at one K/V head a query head."""
    assert flash_attention_bwd.kernels_a_call(sq, sk, group) == want


# -------------------------------------------- the language models' forms --

def _gqa_inputs(b, hkv, group, sq, sk, d, seed):
    """(B, Hq, Sq, d) q, (B, Hkv, Sk, d) k and v, and an output weight."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hkv * group, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                          (b, hkv * group, sq, d))]


def _port_grads(q, k, v, w, **form):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*ts, **form)
    torch.sum(out * torch.from_numpy(w)).backward()
    return [t.grad.numpy() for t in ts]


def _bshd(x):  # (B, H, S, d) -> the reference's (B, S, H, d)
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _jax_grads(fn, q, k, v, w):
    """jax.grad of sum(fn(q, k, v) * w) in the reference's layout,
    returned in the port's."""
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * _bshd(w)),
                     argnums=(0, 1, 2))(_bshd(q), _bshd(k), _bshd(v))
    return [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]


def _mask(sq, sk, causal, window):
    """The reference's (1, 1, Sq, Sk) bool mask, queries end-aligned."""
    qi = np.arange(sq)[:, None] + (sk - sq)
    ki = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= ki <= qi
    if window > 0:
        m &= ki > qi - window
    return jnp.asarray(m[None, None])


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("group", [1, 3, 5, 9])
def test_lm_attention_grads_match_gqa_sdpa(group, window, softcap, d):
    """Causal self-attention at 48 tokens: FlashAttentionFn's gradients
    against jax.grad of the reference's ``gqa_sdpa`` (queries grouped
    (Hkv, G), K/V never repeated) under the same mask and cap."""
    q, k, v, w = _gqa_inputs(2, 2 if group < 5 else 1, group, 48, 48, d,
                             seed=group * 100 + window + d)
    form = dict(causal=True, window=window, softcap=softcap)
    want = _jax_grads(lambda q, k, v: jatt.gqa_sdpa(
        q, k, v, _mask(48, 48, True, window), softcap), q, k, v, w)
    for name, g, x in zip("qkv", _port_grads(q, k, v, w, **form), want):
        np.testing.assert_allclose(g, x, err_msg=name, **TOL)


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 8)])
@pytest.mark.parametrize("group", [1, 5])
def test_end_aligned_queries_match_gqa_sdpa(group, causal, window, d):
    """Sq != Sk: 12 queries against 40 keys, end-aligned as the kernel
    aligns them (non-causal: the decoder's cross attention; causal: a
    suffix of the sequence), against ``gqa_sdpa`` with that mask."""
    q, k, v, w = _gqa_inputs(1, 2, group, 12, 40, d, seed=group + d + window)
    form = dict(causal=causal, window=window, softcap=0.0)
    want = _jax_grads(lambda q, k, v: jatt.gqa_sdpa(
        q, k, v, _mask(12, 40, causal, window)), q, k, v, w)
    for name, g, x in zip("qkv", _port_grads(q, k, v, w, **form), want):
        np.testing.assert_allclose(g, x, err_msg=name, **TOL)


@pytest.mark.parametrize("group,sq,sk,window,softcap", [
    (5, 48, 48, 16, 0.0), (3, 40, 40, 0, 30.0), (9, 20, 44, 0, 0.0),
    (1, 48, 48, 16, 30.0),
])
def test_lm_attention_grads_match_chunked_gqa_sdpa(group, sq, sk, window, softcap):
    """The reference's long-sequence path, ``chunked_gqa_sdpa`` (online
    softmax over 16 x 16 tiles, the q-block body checkpointed), causal
    with queries end-aligned (``q_offset = Sk - Sq``)."""
    q, k, v, w = _gqa_inputs(1, 2, group, sq, sk, 16, seed=group + sq + sk)
    form = dict(causal=True, window=window, softcap=softcap)
    want = _jax_grads(lambda q, k, v: jatt.chunked_gqa_sdpa(
        q, k, v, causal=True, window=window, q_offset=sk - sq, softcap=softcap,
        block_q=16, block_k=16), q, k, v, w)
    for name, g, x in zip("qkv", _port_grads(q, k, v, w, **form), want):
        np.testing.assert_allclose(g, x, err_msg=name, **TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,softcap", [
    (1, 6, 2, 9, 9, 8, True, 3, 0.0), (2, 4, 1, 7, 11, 4, True, 0, 2.0),
    (1, 3, 3, 11, 6, 8, True, 4, 1.5), (1, 4, 2, 5, 9, 12, False, 0, 3.0),
])
def test_plain_backward_forms_match_autograd_of_plain_forward(
        b, hq, hkv, sq, sk, d, causal, window, softcap):
    """flash_attention_bwd_ref's grouped, windowed and capped forms from
    the forward's lse against float64 autograd of the plain forward
    (rows with no visible key, which give 0, among them)."""
    rng = np.random.default_rng(sq * sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).double() for s in
               ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    w = torch.from_numpy(rng.standard_normal((b, hq, sq, d)))
    form = dict(causal=causal, window=window, softcap=softcap)
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    torch.sum(flash_attention_ref(*ts, **form) * w).backward()
    out, lse = flash_attention_ref(q.float(), k.float(), v.float(),
                                   return_lse=True, **form)
    got = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out, w.float(),
                                  lse, **form)
    for name, t, g in zip("qkv", ts, got):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name, **TOL)
