"""The attention gradient in the PyTorch port (``FlashAttentionFn``, its
CPU path: the plain forward with its row log-sum-exp, then the plain
backward) against ``jax.grad`` of the reference's forms on the same numpy
inputs: the einsum softmax of ``src/repro/core/encoders.py`` alone, and
the whole transformer encoder (``encoder_apply``) from the reference's
initial weights.

Tolerance: rtol 1e-4, atol 1e-5 (f32 on the CPU). Head dims are 16 and
64, powers of 4, where the port's scale ``1 / sqrt(hd)`` and the
reference's division by ``sqrt(hd)`` agree exactly (ROADMAP fault (e)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as jenc
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
    """bf16, grouped K/V heads and a window wait for the language model's
    training (ROADMAP item 15); without a gradient the same calls run."""
    q = torch.zeros((1, 4, 5, 8), requires_grad=True)
    kv = torch.zeros((1, 2, 5, 8))
    k4 = torch.zeros((1, 4, 5, 8))
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_attention(q, kv, kv, causal=True)  # GQA
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_attention(q, k4, k4, causal=True, window=2)
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_attention(q.detach().bfloat16().requires_grad_(True),
                        k4.bfloat16(), k4.bfloat16(), causal=True)
    with torch.no_grad():
        assert flash_attention(q, kv, kv, causal=True, window=2).shape == q.shape


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
