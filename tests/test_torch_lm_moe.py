"""The mixture-of-experts language models of the PyTorch port
(deepseek-moe-16b: 64 routed experts top-6 and 2 shared, reduced to 4
top-2 and 1; dbrx-132b: 16 top-4, reduced to 4 top-2) against the JAX
reference on the CPU, each at ``reduced()``, and the flat dispatch alone
with capacity overflow. Tolerances: ``tests/_torch_lm_parity.py``.

Routing: both packages pick the top-k experts of each token; ties may
come in another order (``jax.lax.top_k`` against ``torch.topk``), which
moves nothing (queue positions depend on token order only), so each run
checks the reference's top-k / (k+1) probability gaps stay above 1e-5.
As in the reference's own test, decode is not held against forward on
the extended sequence: capacity routing drops tokens as a function of
the whole batch.
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
from repro_torch.models import backbone as tbb
from repro_torch.models import moe as tmoe

NAMES = ("deepseek_moe_16b", "dbrx_132b")
GAP = 1e-5


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


def test_prefill_matches_forward(lm):
    P.check_prefill_matches_forward(lm, decode=False)


def test_serve_lm_generate_matches_jax_greedy(lm):
    P.check_generate(lm)


def _moe_case(name, capacity_factor, seed):
    jc = P.jget(name).reduced().replace(capacity_factor=capacity_factor)
    tc = get_config(name).reduced().replace(capacity_factor=capacity_factor)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 24, jc.d_model)).astype(np.float32)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_flat_matches_jax_with_overflow(name, capacity_factor):
    """``_moe_flat``: the routed output and the aux loss, with assignments
    dropped at capacity (factor 0.5: at most half of them fit)."""
    jc, tc, jp, tp, x = _moe_case(name, capacity_factor, seed=3)
    want, waux = jmoe._moe_flat(jp, jc, jnp.asarray(x))
    got, aux = tmoe._moe_flat(tp, tc, torch.from_numpy(x))
    P.close(got.numpy(), want)
    P.close(float(aux), float(waux))
    _, widx, wprobs = jmoe._route(jp, jc, jnp.asarray(x.reshape(-1, jc.d_model)))
    top = np.sort(np.asarray(wprobs), -1)[:, ::-1]
    assert (top[:, jc.top_k - 1] - top[:, jc.top_k]).min() > GAP
    _, gidx, _ = tmoe._route(tp, tc, torch.from_numpy(x.reshape(-1, jc.d_model)))
    assert np.array_equal(np.sort(gidx.numpy(), -1), np.sort(np.asarray(widx), -1))
    cap = tmoe._capacity(x.shape[0] * x.shape[1], tc)
    assert cap == jmoe._capacity(x.shape[0] * x.shape[1], jc)
    slot, keep = tmoe._dispatch_indices(gidx, tc.n_experts, cap)
    wslot, wkeep = jmoe._dispatch_indices(widx, jc.n_experts, cap)
    assert np.array_equal(keep.numpy(), np.asarray(wkeep))
    assert np.array_equal(slot.numpy(), np.asarray(wslot))
    if capacity_factor < 1:
        assert not bool(keep.all())  # some assignments overflowed
