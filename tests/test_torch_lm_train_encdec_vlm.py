"""Training the encoder-decoder (whisper: bidirectional encoder over 64
frames, causal decoder, cross attention with Sq = 48 queries against 64
keys) and the VLM (qwen2-vl: 8 stub patches before the text, M-RoPE, G
= 6, the loss over the text region only) of the PyTorch port against the
JAX reference on the CPU: ``loss_fn`` and every gradient (the
frontends' among them) against ``jax.value_and_grad`` of the
reference's. Tolerances: ``tests/_torch_lm_train_parity.py``.
"""
import pytest

import _torch_lm_train_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)


@pytest.mark.parametrize("name", ["whisper_medium", "qwen2_vl_2b"])
def test_loss_and_gradients_match_jax(name):
    T.check_loss_and_gradients(name)


def test_vlm_with_more_patches_matches_jax():
    """More patches than text tokens (64 before 48): the loss slices the
    text region past a longer prefix."""
    T.check_loss_and_gradients("qwen2_vl_2b", vision_tokens=64)
