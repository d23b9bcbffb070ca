"""bf16 training of the PyTorch port against the JAX reference on the
CPU (the production numerics of ``launch/specs.py``; see
``tests/test_torch_lm_train_bf16.py``): whisper-medium (the encoder,
decoder self and cross attention under ``remat``, learned positions)
and deepseek-moe-16b with the grouped MoE dispatch at moe_groups = 2
(4 x 48 tokens in 2 groups), each at ``reduced()``, 2 layers (whisper
2 + 2). deepseek's router choices are the reference's, replayed (in
bf16 a token's k-th and (k+1)-th expert can sit within the two runs'
rounding), in the order both sides run their routers: each layer's
forward, then each layer again in the backward (the rematerialized
forward, last layer first); the rest of each layer is compared.
Tolerances:
``tests/_torch_lm_train_bf16_parity.py``."""
import pytest

import _torch_lm_train_bf16_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {"whisper_medium": {}, "deepseek_moe_16b": {"moe_groups": 2}}


@pytest.fixture(scope="module", params=list(CASES))
def ref(request):
    return T.reference(request.param, **CASES[request.param])


def test_bf16_loss_and_gradients_match_jax(ref):
    T.check_loss_and_gradients(ref)


def test_bf16_adamw_step_matches_jax(ref):
    T.check_adamw_step(ref)


def test_bf16_bound_rejects_a_zeroed_attention_backward(ref):
    assert T.control_share(ref) > 1.0


def test_remat_gives_the_same_bits(ref):
    T.check_remat_bit_for_bit(ref)

