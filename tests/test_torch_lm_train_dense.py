"""Training the dense language models of the PyTorch port (phi4-mini,
starcoder2, nemotron, stablelm) against the JAX reference on the CPU:
``loss_fn`` and every gradient against ``jax.value_and_grad`` of the
reference's ``loss_fn``, at narrow widths that keep each family's group
G (phi4 3, starcoder2 9, nemotron 6; stablelm's head dim 80), plus
phi4 with a logit cap of 30, a sliding window of 16 at 48 tokens, and a
loss mask. The attention's gradient runs ``FlashAttentionFn``'s CPU path
(the plain forward with its log-sum-exp, then the plain backward).
Tolerances: ``tests/_torch_lm_train_parity.py``.
"""
import pytest

import _torch_lm_train_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)


@pytest.mark.parametrize("name", ["phi4_mini_3p8b", "starcoder2_7b",
                                  "nemotron_4_15b", "stablelm_3b"])
def test_loss_and_gradients_match_jax(name):
    T.check_loss_and_gradients(name)


@pytest.mark.parametrize("extra", [
    dict(attn_logit_softcap=30.0),
    dict(attn_kind="sliding", window=16),
    dict(attn_kind="sliding", window=16, attn_logit_softcap=30.0),
], ids=["softcap", "window", "window_softcap"])
def test_phi4_forms_match_jax(extra):
    """The forms no published dense config sets, through the whole model:
    the logit cap and a window that binds."""
    T.check_loss_and_gradients("phi4_mini_3p8b", **extra)


def test_loss_mask_matches_jax():
    """A loss mask over the text positions, as the reference's loss_fn
    takes it."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import backbone as jbb
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import backbone as tbb

    jc, tc, jp, tp = T.model("phi4_mini_3p8b")
    (batch,) = T.batches(jc, 1, seed=4)
    batch["loss_mask"] = (np.random.default_rng(4).random(
        batch["labels"].shape) < 0.6).astype(np.float32)
    (jt, _), jg = jax.value_and_grad(jbb.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    total, _, grads = tbb._value_and_grad(
        tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jt), rtol=T.LOSS_RTOL)
    T.assert_leafwise(jax.tree.map(np.asarray, jg), params_to_numpy(grads),
                      T.GRAD_REL, "gradient")
