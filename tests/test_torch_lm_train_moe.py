"""Training the MoE language models of the PyTorch port (deepseek-moe
with its shared experts, dbrx at group G = 6) against the JAX reference
on the CPU: ``loss_fn`` (the router's aux term among it) and every
gradient against ``jax.value_and_grad`` of the reference's; three AdamW
steps of deepseek-moe against the reference's jitted
``make_train_step``; and the MoE layer alone at a capacity that drops
assignments: the ``index_add_`` dispatch, the spill slot (whose rows get
no gradient) and the aux loss against ``jax.grad`` of the reference's
``_moe_flat``. Tolerances: ``tests/_torch_lm_train_parity.py``.

The AdamW steps run deepseek-moe, not dbrx: dbrx's run at these widths
has an expert weight whose gradient lies within 1e-9 of 0, and AdamW's
sqrt(v) + 1e-8 turns its f32 noise into a step of up to lr_t, 0.11 of
the summed rates apart, past the tenth the check allows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_train_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)
from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import moe as tmoe


@pytest.mark.parametrize("name", ["deepseek_moe_16b", "dbrx_132b"])
def test_loss_and_gradients_match_jax(name):
    T.check_loss_and_gradients(name)


def test_three_adamw_steps_match_reference_train_step():
    jc, tc, jp, tp = T.model("deepseek_moe_16b")
    T.check_three_adamw_steps(jc, tc, jp, tp, T.batches(jc, 3, seed=1))


@pytest.mark.parametrize("name,capacity_factor", [
    ("deepseek_moe_16b", 0.5), ("dbrx_132b", 0.5), ("dbrx_132b", 1.25)])
def test_moe_layer_gradients_match_jax(name, capacity_factor):
    """The flat dispatch under a capacity that drops assignments (0.5)
    and one that keeps most (1.25): the output, the aux loss and the
    gradients of the router, the experts, the shared experts and the
    input; the dropped assignments add nothing."""
    jc, tc = T.narrow(name, capacity_factor=capacity_factor)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe._moe_flat(p, jc, x)
        return jnp.sum(out * w) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves, treedef = jax.tree.flatten(tp)
    leaves = [t.requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe._moe_flat(jax.tree.unflatten(treedef, leaves), tc, tx)
    (torch.sum(out * torch.from_numpy(w)) + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=T.LOSS_RTOL)
    T.assert_leafwise(jax.tree.map(np.asarray, jgp), params_to_numpy(
        jax.tree.unflatten(treedef, [t.grad for t in leaves])), T.GRAD_REL,
        "gradient")
    T.assert_leafwise({"x": np.asarray(jgx)}, {"x": tx.grad.numpy()},
                      T.GRAD_REL, "input gradient")
    if capacity_factor < 1:  # some assignments were dropped
        _, idx, _ = tmoe._route(tp, tc, tx.detach().reshape(-1, jc.d_model))
        cap = tmoe._capacity(48, tc)
        _, keep = tmoe._dispatch_indices(idx, tc.n_experts, cap)
        assert not bool(keep.all())
