"""Training the hybrid language model of the PyTorch port (hymba-1.5b:
sliding-window GQA attention beside Mamba heads in every block) against
the JAX reference on the CPU, at narrow widths that keep its group G = 5
and a window of 16 that binds at 48 tokens: ``loss_fn`` and every
gradient against ``jax.value_and_grad`` of the reference's, and three
AdamW steps against the reference's jitted ``make_train_step``. The
attention's gradient runs ``FlashAttentionFn``'s CPU path, the Mamba
heads' ``MLSTMScanFn``'s (``normalize=False``). Tolerances:
``tests/_torch_lm_train_parity.py``.
"""
import pytest

import _torch_lm_train_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)

NAME = "hymba_1p5b"


@pytest.mark.parametrize("extra", [{}, dict(window=64)], ids=["window16", "window64"])
def test_loss_and_gradients_match_jax(extra):
    """The window binding (16 of 48 tokens) and not (64)."""
    T.check_loss_and_gradients(NAME, **extra)


def test_three_adamw_steps_match_reference_train_step():
    jc, tc, jp, tp = T.model(NAME)
    T.check_three_adamw_steps(jc, tc, jp, tp, T.batches(jc, 3, seed=1))
