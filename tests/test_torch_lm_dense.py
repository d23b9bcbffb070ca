"""The dense language models of the PyTorch port (phi4-mini-3.8b,
starcoder2-7b, nemotron-4-15b, stablelm-3b: attention blocks with a
SwiGLU, GELU or squared-ReLU MLP) against the JAX reference on the CPU,
each at ``reduced()``: init shapes, forward, prefill logits and cache, 4
greedy decode steps, decoding from the reference's cache, the port's
prefill / decode consistency and ``serve_lm.generate``. Tolerances:
``tests/_torch_lm_parity.py``.
"""
import pytest

import _torch_lm_parity as P

NAMES = ("phi4_mini_3p8b", "starcoder2_7b", "nemotron_4_15b", "stablelm_3b")


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
    P.check_prefill_matches_forward(lm, decode=True)


def test_serve_lm_generate_matches_jax_greedy(lm):
    P.check_generate(lm)
