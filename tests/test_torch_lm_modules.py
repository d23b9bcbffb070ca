"""The language models' layers in the PyTorch port against the JAX
reference on the CPU: rotary embeddings (1-D and M-RoPE, the positions
of text and of a vision prefix), the MLP activations, and attention
(``attend`` through the flash kernel's plain version) against both of
the reference's paths: ``gqa_sdpa`` below ``CHUNKED_THRESHOLD`` and
``chunked_gqa_sdpa`` at or above it, causal with GQA, sliding windows,
the encoder's non-causal form, cross-attention, a logit softcap, and the
decode steps against a ring cache.

Tolerances: positions exactly; angles and rotations 1e-5 (the
frequencies' f32 power in another library); the rest 1e-4 as in
``tests/_torch_lm_parity.py``. The flash plain version takes an exact
softmax; the reference's one-shot softmax and its chunked online
softmax sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_parity as P
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp
from repro_torch.models import rope as trope


def _both(name, **replace):
    jc, tc = P.jget(name).reduced(), get_config(name).reduced()
    return jc.replace(**replace), tc.replace(**replace)


@pytest.mark.parametrize("n_vision,n_text", [(0, 7), (9, 5), (12, 3), (8, 0)])
def test_mrope_and_text_positions_match_reference(n_vision, n_text):
    want = jrope.mrope_positions(2, n_vision, n_text)
    got = trope.mrope_positions(2, n_vision, n_text)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(trope.text_positions(3, n_text).numpy(),
                          jrope.text_positions(3, n_text))


@pytest.mark.parametrize("name", ["phi4_mini_3p8b", "qwen2_vl_2b"])
@pytest.mark.parametrize("full", [False, True])
def test_rope_angles_and_apply_match_reference(name, full):
    """1-D RoPE and M-RoPE (the reduced sections, and the full model's
    (16, 24, 24) over head dim 128), positions to 2100."""
    cfg = get_config(name) if full else get_config(name).reduced()
    sections = cfg.mrope_sections if cfg.pos == "mrope" else None
    rng = np.random.default_rng(0)
    if sections:
        pos = np.asarray(jrope.mrope_positions(2, 2048, 52))
    else:
        pos = np.broadcast_to(np.arange(2100, dtype=np.int32), (2, 2100))
    want = jrope.rope_angles(jnp.asarray(pos), cfg.hd, cfg.rope_theta, sections)
    got = trope.rope_angles(torch.from_numpy(pos.copy()), cfg.hd, cfg.rope_theta,
                            sections)
    P.close(got.numpy(), want, atol=1e-5, rtol=1e-5)
    x = rng.standard_normal((2, pos.shape[1], 3, cfg.hd)).astype(np.float32)
    P.close(trope.apply_rope(torch.from_numpy(x), got).numpy(),
            jrope.apply_rope(jnp.asarray(x), want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp_activations_match_reference(act):
    jp = jmlp.mlp_init(jax.random.PRNGKey(5), 48, 96, act, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(tp) == sorted(tmlp.mlp_init(torch.Generator(), 48, 96, act,
                                              torch.float32, device="cpu"))
    x = np.random.default_rng(1).standard_normal((2, 7, 48)).astype(np.float32) * 2
    P.close(tmlp.mlp(tp, torch.from_numpy(x), act).numpy(),
            jmlp.mlp(jp, jnp.asarray(x), act))


ATTN_CASES = {  # name: (config, replace, sq, sk or None, causal)
    "causal_gqa": ("phi4_mini_3p8b", {}, 33, None, True),
    "sliding": ("hymba_1p5b", {"window": 8}, 40, None, True),
    "encoder": ("whisper_medium", {}, 24, None, False),
    "cross": ("whisper_medium", {}, 5, 24, False),
    "qkv_bias_mrope": ("qwen2_vl_2b", {}, 20, None, True),
    "head_dim_80": ("stablelm_3b", {"head_dim": 80}, 17, None, True),
    "softcap": ("phi4_mini_3p8b", {"attn_logit_softcap": 5.0}, 21, None, True),
    # at CHUNKED_THRESHOLD (2048 x 2048): the reference's chunked path
    "chunked_causal": ("phi4_mini_3p8b", {}, 2048, None, True),
    "chunked_sliding": ("hymba_1p5b", {"window": 300}, 2048, None, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attend_matches_reference(case):
    name, replace, sq, sk, causal = ATTN_CASES[case]
    jc, tc = _both(name, **replace)
    jp = jattn.attn_init(jax.random.PRNGKey(7), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, sq, jc.d_model)).astype(np.float32)
    kv = (None if sk is None
          else rng.standard_normal((2, sk, jc.d_model)).astype(np.float32))
    if sk is None and jc.pos == "mrope":
        pos = np.array(jrope.mrope_positions(2, 8, sq - 8))
    elif sk is None and jc.pos == "rope":
        pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq)).copy()
    else:
        pos = None
    assert (sq * (sk or sq) >= jattn.CHUNKED_THRESHOLD) == case.startswith("chunked")
    want, (wk, wv) = jattn.attend(jp, jc, jnp.asarray(x),
                                  None if pos is None else jnp.asarray(pos),
                                  causal=causal,
                                  kv_x=None if kv is None else jnp.asarray(kv))
    got, (gk, gv) = tattn.attend(tp, tc, torch.from_numpy(x),
                                 None if pos is None else torch.from_numpy(pos),
                                 causal=causal,
                                 kv_x=None if kv is None else torch.from_numpy(kv))
    P.close(got.numpy(), want)
    P.close(gk.numpy(), wk)
    P.close(gv.numpy(), wv)


@pytest.mark.parametrize("name,index", [("phi4_mini_3p8b", 5), ("phi4_mini_3p8b", 40),
                                        ("hymba_1p5b", 9), ("hymba_1p5b", 70),
                                        ("stablelm_3b", 0)])
def test_decode_attend_matches_reference(name, index):
    """One decode step against a random ring cache, before and after it
    wraps (the window of 8 or max_len 16), then cross-attention."""
    jc, tc = _both(name, window=8)
    jp = jattn.attn_init(jax.random.PRNGKey(9), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(index)
    length = 8 if jc.attn_kind == "sliding" else 16
    cache = {k: rng.standard_normal((2, length, jc.n_kv_heads, jc.hd)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    want, wc = jattn.decode_attend(jp, jc, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, cache), jnp.asarray(index))
    got, gc = tattn.decode_attend(tp, tc, torch.from_numpy(x),
                                  params_from_numpy(cache, "cpu"), index)
    P.close(got.numpy(), want)
    P.trees_close(params_to_numpy(gc), wc)
    cross = (cache["k"], cache["v"])
    want = jattn.decode_cross_attend(jp, jc, jnp.asarray(x),
                                     tuple(jnp.asarray(c) for c in cross))
    got = tattn.decode_cross_attend(tp, tc, torch.from_numpy(x),
                                    tuple(torch.from_numpy(c) for c in cross))
    P.close(got.numpy(), want)
