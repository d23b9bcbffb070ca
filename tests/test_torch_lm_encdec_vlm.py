"""The encoder-decoder and vision-language models of the PyTorch port
(whisper-medium: learned positions, an audio frontend stub, cross-
attention; qwen2-vl-2b: a vision prefix of patch embeddings under
M-RoPE, QKV biases) against the JAX reference on the CPU, each at
``reduced()``: init shapes, forward, prefill logits and cache (whisper's
cross-attention K/V tuples included), 4 greedy decode steps, decoding
from the reference's cache, the port's prefill / decode consistency and
``serve_lm.generate``. Tolerances: ``tests/_torch_lm_parity.py``.

qwen2-vl's decode positions are the raw cache index on all three M-RoPE
axes, as in the reference (``src/repro/models/backbone.py:311``), where
the full-sequence text positions start at grid + 1 after the patches: a
decode step does not equal forward on the extended sequence there, in
either package, so its consistency check stops at prefill.
"""
import numpy as np
import pytest
import torch

import _torch_lm_parity as P
from repro.models import backbone as jbb
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import backbone as tbb

NAMES = ("whisper_medium", "qwen2_vl_2b")


@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    return P.reference_run(request.param)


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_match_reference(name):
    P.check_init_shapes(name)


def test_forward_matches_jax(lm):
    P.check_forward(lm)


def test_prefill_logits_and_cache_match_jax(lm):
    P.check_prefill(lm)


def test_greedy_decode_matches_jax(lm):
    P.check_greedy_decode(lm)


def test_decode_from_the_reference_cache(lm):
    P.check_decode_from_reference_cache(lm)


def test_prefill_matches_forward_and_decode_consistent(lm):
    P.check_prefill_matches_forward(lm, decode=lm["tc"].pos != "mrope")


def test_serve_lm_generate_matches_jax_greedy(lm):
    P.check_generate(lm)


@pytest.mark.parametrize("name", NAMES)
def test_init_cache_matches_reference(name):
    """The zero decode cache: the reference's tree, shapes and dtypes,
    whisper's cross cache at the given encoder length."""
    jc, tc = P.jget(name).reduced(), get_config(name).reduced()
    want = jbb.init_cache(jc, 2, 16, enc_len=24)
    got = tbb.init_cache(tc, 2, 16, enc_len=24, device="cpu")
    P.trees_close(params_to_numpy(got), want, atol=0)
    assert all(bool((x == 0).all()) for x in P.jax.tree.leaves(params_to_numpy(got)))


def test_vlm_inputs_and_positions():
    """The VLM's embedded inputs: patches first, M-RoPE positions with the
    text from grid + 1 on, equal to the reference's."""
    jc, tc = P.jget("qwen2_vl_2b").reduced(), get_config("qwen2_vl_2b").reduced()
    p = tbb.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = P.prompt(tc, b=2, s=5)
    x, pos = tbb._embed_inputs(p, tc, P.to_torch(batch))
    n_vis = tc.vision_tokens
    assert tuple(x.shape) == (2, n_vis + 5, tc.d_model)
    grid = max(int(n_vis ** 0.5), 1)
    assert pos[0, n_vis].tolist() == [grid + 1] * 3
    jp = P.jax.tree.map(np.asarray, P.jbb.init_params(P.jax.random.PRNGKey(0), jc))
    wx, wpos, _ = P.jbb._embed_inputs(P.jax.tree.map(P.jnp.asarray, jp), jc,
                                      P.to_jax(batch))
    gx, gpos = tbb._embed_inputs(params_from_numpy(jp, "cpu"), tc,
                                 P.to_torch(batch))
    assert np.array_equal(gpos.numpy(), wpos)
    P.close(gx.numpy(), wx)
