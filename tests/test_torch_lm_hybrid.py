"""The hybrid language model of the PyTorch port (hymba-1.5b: parallel
sliding-window attention and Mamba heads a block) against the JAX
reference on the CPU at ``reduced()``, the Mamba heads alone, and the
ring-buffer KV cache past a wrap. Tolerances: ``tests/_torch_lm_parity.py``;
the Mamba heads' scan runs the mLSTM scan kernel's plain version (the
step recurrence) where the reference runs its chunkwise XLA form: 1e-4.

The ring: the port keeps absolute position p at slot p % length, so a
decode step after a prompt longer than the window equals forward on the
extended sequence. The reference's ``_kv_to_ring`` permutes the kept
tail so that this holds only when (S - length) % length is 0 or
length / 2 (ROADMAP fault (l)); the two packages are compared at such
lengths, and the port alone at the others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_parity as P
from repro.models import blocks as jblocks
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import backbone as tbb
from repro_torch.models import blocks as tblocks

NAME = "hymba_1p5b"


@pytest.fixture(scope="module")
def lm():
    return P.reference_run(NAME)


def test_init_shapes_match_reference():
    P.check_init_shapes(NAME)


def test_forward_matches_jax(lm):
    P.check_forward(lm)


def test_prefill_logits_and_cache_match_jax(lm):
    P.check_prefill(lm)


def test_greedy_decode_matches_jax(lm):
    P.check_greedy_decode(lm)


def test_decode_from_the_reference_cache(lm):
    P.check_decode_from_reference_cache(lm)


def test_prefill_matches_forward_and_decode_consistent(lm):
    P.check_prefill_matches_forward(lm, decode=True)


def test_serve_lm_generate_matches_jax_greedy(lm):
    P.check_generate(lm)


def _layer(lm):
    return (jax.tree.map(lambda x: x[0], lm["jp"]["layers"]),
            jax.tree.map(lambda x: x[0], lm["tp"]["layers"]))


@pytest.mark.parametrize("s", [1, 9, 70])
def test_mamba_apply_and_step_match_jax(lm, s):
    """The Mamba heads over a sequence (output and final (C, n)) and one
    decode step from that state."""
    jlp, tlp = _layer(lm)
    x = np.random.default_rng(s).standard_normal((2, s, lm["jc"].d_model)).astype(np.float32)
    wy, wst = jblocks.mamba_apply(jlp["mamba"], lm["jc"], jnp.asarray(x),
                                  return_state=True)
    gy, gst = tblocks.mamba_apply(tlp["mamba"], lm["tc"], torch.from_numpy(x),
                                  return_state=True)
    P.close(gy.numpy(), wy)
    P.trees_close(params_to_numpy(gst), wst)
    x1 = x[:, :1]
    wd, wdst = jblocks.mamba_step(jlp["mamba"], lm["jc"], jnp.asarray(x1), wst)
    gd, gdst = tblocks.mamba_step(tlp["mamba"], lm["tc"], torch.from_numpy(x1), gst)
    P.close(gd.numpy(), wd)
    P.trees_close(params_to_numpy(gdst), wdst)


def test_hybrid_block_and_prefill_match_jax(lm):
    jlp, tlp = _layer(lm)
    x = np.random.default_rng(4).standard_normal((2, 10, lm["jc"].d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want, _ = jblocks.hybrid_block(jlp, lm["jc"], jnp.asarray(x), jnp.asarray(pos))
    got, _ = tblocks.hybrid_block(tlp, lm["tc"], torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()))
    P.close(got.numpy(), want)
    wy, wc = jblocks.hybrid_block_prefill(jlp, lm["jc"], jnp.asarray(x),
                                          jnp.asarray(pos), 16, jnp.float32)
    gy, gc = tblocks.hybrid_block_prefill(tlp, lm["tc"], torch.from_numpy(x),
                                          torch.from_numpy(pos.copy()), 16,
                                          torch.float32)
    P.close(gy.numpy(), wy)
    P.trees_close(params_to_numpy(gc), wc)


def _ring(pkg, cfg, s, length, max_len=100):
    k = np.arange(s, dtype=np.float32).reshape(1, s, 1, 1)
    if pkg == "jax":
        out = jblocks._kv_to_ring(cfg, jnp.asarray(k), jnp.asarray(-k), max_len,
                                  jnp.float32)
        return np.asarray(out["k"]).ravel(), np.asarray(out["v"]).ravel()
    out = tblocks._kv_to_ring(cfg, torch.from_numpy(k), torch.from_numpy(-k),
                              max_len, torch.float32)
    return out["k"].numpy().ravel(), out["v"].numpy().ravel()


@pytest.mark.parametrize("s", [3, 8, 12, 16, 24, 5, 9, 13, 21])
def test_kv_to_ring_past_a_wrap(s):
    """Slot p % length holds position p, the last ``length`` positions
    kept (zeros in unwritten slots before a wrap); equal to the
    reference where its permutation is right (s <= length, (s - length)
    % length in {0, length / 2})."""
    length = 8
    jc = P.jget(NAME).reduced().replace(window=length)
    tc = get_config(NAME).reduced().replace(window=length)
    gk, gv = _ring("torch", tc, s, length)
    assert np.array_equal(gv, -gk)
    want = np.zeros(length, np.float32)
    for p in range(max(0, s - length), s):
        want[p % length] = p
    assert np.array_equal(gk, want)
    if s <= length or (s - length) % length in (0, length // 2):
        wk, wv = _ring("jax", jc, s, length)
        assert np.array_equal(gk, wk) and np.array_equal(gv, wv)


@pytest.mark.parametrize("prompt", [20, 21])
def test_decode_past_the_window_matches_forward(prompt):
    """The reference test's sliding-window check on the port (its
    prompt of 20 and one, 21, where the reference's ring is misplaced):
    4 decode steps after a prompt longer than the window, each equal to
    forward over the whole sequence (reduced phi4, window 8)."""
    cfg = get_config("phi4_mini_3p8b").reduced().replace(attn_kind="sliding",
                                                         window=8)
    jc = P.jget("phi4_mini_3p8b").reduced().replace(attn_kind="sliding", window=8)
    from repro.models import backbone as jbb

    params = params_from_numpy(jax.tree.map(
        np.asarray, jbb.init_params(jax.random.PRNGKey(2), jc)), "cpu")
    rng = np.random.default_rng(2)
    cur = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt)).astype(np.int32))
    _, cache, idx = tbb.prefill(params, cfg, {"tokens": cur}, max_len=64)
    assert cache["k"].shape[2] == 8
    for i in range(4):
        nt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1)).astype(np.int32))
        lg, cache = tbb.decode_step(params, cfg, nt, cache, idx + i)
        cur = torch.cat([cur, nt], dim=1)
        full, _ = tbb.forward(params, cfg, {"tokens": cur})
        P.close(lg[:, 0].numpy(), full[:, -1].numpy(), atol=5e-4, rtol=5e-4)
