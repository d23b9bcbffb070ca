"""bf16 serving of the PyTorch port against the JAX reference on the CPU
(the production numerics of ``launch/specs.py``; see
``tests/test_torch_lm_bf16.py`` for the tolerance and its control): whisper-medium
(encoder, decoder self and cross attention, learned positions) and
deepseek-moe-16b with the grouped MoE dispatch at moe_groups = 2
(prefill's 24 tokens in 2 groups of 12; a decode step's 2 tokens make
groups of 1, under top_k, so the step takes the flat path, as in the
reference), each at ``reduced()``."""
import pytest

import _torch_lm_parity as P
from _torch_parity import one_torch_thread  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {"whisper_medium": {}, "deepseek_moe_16b": {"moe_groups": 2}}


@pytest.fixture(scope="module", params=list(CASES))
def lm(request):
    return P.bf16_run(request.param, **CASES[request.param])


def test_bf16_prefill_and_decode_match_jax(lm):
    P.check_bf16_serving(lm)


@pytest.mark.parametrize("lm", list(CASES), indirect=True)
def test_bf16_bound_rejects_one_zeroed_attention(lm):
    assert P.bf16_control_share(lm, "flash_attention") > 1.0
