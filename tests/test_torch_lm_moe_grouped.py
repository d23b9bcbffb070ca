"""The grouped (GShard) MoE dispatch of the PyTorch port against the JAX
reference on the CPU: ``_moe_grouped`` at G = 1, 2 and 4 groups, with a
capacity factor that drops assignments (0.5: at most half of each
group's fit) and one that drops none (4.0), on deepseek-moe-16b's and
dbrx-132b's reduced configs; the queues (slot, keep) equal the
reference's exactly, the routed output and the aux loss within the LM
tolerances of ``tests/_torch_lm_parity.py``. ``moe_apply`` takes the
grouped path exactly where the reference does (G > 0 dividing the
tokens, groups of at least top_k), and at G = 1 the grouped path gives
the flat path's output. A whole model at moe_groups = 2 is held against
the reference in ``tests/test_torch_lm_bf16.py``.

Routing: as in ``tests/test_torch_lm_moe.py``, each case checks that the
reference's top-k / (k+1) probability gaps stay above 1e-5, so that
ties cannot reorder the picks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_parity as P
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe

NAMES = ("deepseek_moe_16b", "dbrx_132b")
GAP = 1e-5


def _case(name, groups, capacity_factor, seed, tokens=(2, 24)):
    kw = dict(capacity_factor=capacity_factor, moe_groups=groups)
    jc = P.jget(name).reduced().replace(**kw)
    tc = get_config(name).reduced().replace(**kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        tokens + (jc.d_model,)).astype(np.float32)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x


def _gaps_ok(jp, jc, x):
    _, _, probs = jmoe._route(jp, jc, jnp.asarray(x.reshape(-1, jc.d_model)))
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    return (top[:, jc.top_k - 1] - top[:, jc.top_k]).min() > GAP


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
def test_moe_grouped_matches_jax(name, groups, capacity_factor):
    """Output, aux loss and every group's queues against the reference's
    ``_moe_grouped``; factor 0.5 drops assignments in every group, 4.0
    none."""
    jc, tc, jp, tp, x = _case(name, groups, capacity_factor, seed=5)
    assert _gaps_ok(jp, jc, x)
    want, waux = jmoe._moe_grouped(jp, jc, jnp.asarray(x))
    got, aux = tmoe._moe_grouped(tp, tc, torch.from_numpy(x))
    P.close(got.numpy(), want)
    P.close(float(aux), float(waux))

    t = x.shape[0] * x.shape[1]
    tg = t // groups
    capg = tmoe._capacity(tg, tc)
    assert capg == jmoe._capacity(tg, jc)
    xg = x.reshape(groups, tg, jc.d_model)
    _, widx, _ = jmoe._route(jp, jc, jnp.asarray(xg))
    wslot, wkeep = jax.vmap(lambda ei: jmoe._dispatch_indices(ei, jc.n_experts,
                                                             capg))(widx)
    _, gidx, _ = tmoe._route(tp, tc, torch.from_numpy(xg))
    assert np.array_equal(np.sort(gidx.numpy(), -1), np.sort(np.asarray(widx), -1))
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(np.array(widx)),
                                        tc.n_experts, capg, groups=groups)
    assert tuple(slot.shape) == (groups, tg * tc.top_k)
    assert np.array_equal(slot.numpy(), np.asarray(wslot))
    assert np.array_equal(keep.numpy(), np.asarray(wkeep))
    if capacity_factor < 1:
        assert not bool(keep.all(-1).any())  # every group dropped some
    else:
        assert bool(keep.all())


@pytest.mark.parametrize("tokens,groups,grouped", [
    ((2, 24), 4, True),    # 48 tokens, 4 groups of 12
    ((2, 24), 0, False),   # flat
    ((1, 6), 4, False),    # 6 tokens do not cut into 4 groups
    ((1, 3), 3, False),    # groups of 1 token, below top_k = 2
    ((1, 4), 2, True),     # groups of 2 = top_k
])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_picks_the_reference_path(name, tokens, groups, grouped):
    jc, tc, jp, tp, x = _case(name, groups, 1.25, seed=7, tokens=tokens)
    assert _gaps_ok(jp, jc, x)
    assert tmoe.uses_groups(tc, tokens[0] * tokens[1]) == grouped
    want, waux = jmoe.moe_apply(jp, jc, jnp.asarray(x))
    got, aux = tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    P.close(got.numpy(), want)
    P.close(float(aux), float(waux))
    path = jmoe._moe_grouped if grouped else jmoe._moe_flat
    exact, _ = path(jp, jc, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(exact))


@pytest.mark.parametrize("name", NAMES)
def test_one_group_is_the_flat_dispatch(name):
    """At G = 1 the one group is every token, with the flat path's
    capacity: the grouped path gives the flat path's output."""
    _, tc, _, tp, x = _case(name, 1, 0.5, seed=9)
    got, aux = tmoe._moe_grouped(tp, tc, torch.from_numpy(x))
    flat, faux = tmoe._moe_flat(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=1e-6, rtol=1e-6)
    assert float(aux) == float(faux)
