"""bf16 training of the PyTorch port against the JAX reference on the
CPU, at the production numerics of ``launch/specs.py`` (bf16 compute,
f32 parameters, ``remat``; ROADMAP item 15c-1): phi4-mini-3.8b (dense
attention) and hymba-1.5b (its sliding window beside the Mamba heads) at
``reduced()``, 2 layers: the loss and every gradient against
``jax.value_and_grad`` of the reference's ``loss_fn``, one in-place AdamW
step against the reference's ``adamw``; the bounds' controls (the first
attention backward zeroed must fail the gradients', the update's sign
flipped the step's); ``remat`` against none, bit for
bit. The attention's gradient runs ``FlashAttentionFn``'s CPU path in
bf16 (the plain backward in f32 on the bf16 inputs, its gradients cast
down), the Mamba heads' ``MLSTMScanFn`` on inputs cast up.
Tolerances: ``tests/_torch_lm_train_bf16_parity.py``; xlstm-350m in
``tests/test_torch_lm_train_bf16_step.py``, whisper-medium and
deepseek-moe-16b in ``tests/test_torch_lm_train_bf16_encdec_moe.py``.
"""
import pytest

import _torch_lm_train_bf16_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("phi4_mini_3p8b", "hymba_1p5b")


@pytest.fixture(scope="module", params=NAMES)
def ref(request):
    return T.reference(request.param)


def test_bf16_loss_and_gradients_match_jax(ref):
    T.check_loss_and_gradients(ref)


def test_bf16_adamw_step_matches_jax(ref):
    T.check_adamw_step(ref)


def test_bf16_bound_rejects_a_zeroed_attention_backward(ref):
    assert T.control_share(ref) > 1.0


def test_step_bound_rejects_a_flipped_update(ref):
    assert T.flipped_step_share(ref) > 1.0


def test_remat_gives_the_same_bits(ref):
    T.check_remat_bit_for_bit(ref)
