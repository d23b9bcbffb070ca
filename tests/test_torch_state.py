"""The port's round-state registry and K-of-C primitives
(``repro_torch.core.state``) against the reference's, on the CPU.

Every registered block (stacked models, optimizer moments, codec
residuals, control variates, the global blocks, the async counters and
the ``sched`` telemetry) is gathered by sampled ids and scattered back
on both sides, and declared as the reference declares it.
Gathers and scatters move values without arithmetic, so the two agree
bit for bit. A scatter returns new tensors: the state it was given is
left as it was, and no scattered leaf shares storage with it (torch
tensors alias where JAX arrays do not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.core import state as jstate
from repro_torch.convert import params_from_numpy
from repro_torch.core import state as tstate

C = 6


def _tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (3, 2)).astype(np.float32),
            "b": rng.standard_normal(lead + (2,)).astype(np.float32),
            "hidden": [{"w": rng.standard_normal(lead + (2, 2)).astype(np.float32)}]}


def _groups(rng, lead=()):
    return {g: _tree(rng, lead) for g in tstate.CLIENT_GROUPS}


def _state(seed=0) -> dict:
    """A round state holding every registered block, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "models": _groups(rng, (C,)),
        "opt": {"step": np.asarray(7, np.int32), "mu": _groups(rng, (C,)),
                "nu": _groups(rng, (C,))},
        "codec": {"resid_up": _groups(rng, (C,)), "resid_down": _groups(rng)},
        "strat": {"c_global": _groups(rng), "c_local": _groups(rng, (C,)),
                  "srv": {"m": _groups(rng), "t": np.asarray(2, np.int32)}},
        "server_gmv": _tree(rng),
        "global_models": _groups(rng),
        "srv_opt": {"step": np.asarray(3, np.int32), "mu": _tree(rng)},
        "last_round": rng.integers(-1, 4, C).astype(np.int32),
        "round": np.asarray(4, np.int32),
        "sched": {"omega_ema": rng.random(C).astype(np.float32),
                  "part_count": rng.integers(0, 4, C).astype(np.int32),
                  "last_round": rng.integers(-1, 4, C).astype(np.int32)},
    }


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x), tree)


def _equal(want, got):
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b),
                                                            np.asarray(a)),
                 want, got)


def test_registry_matches_reference():
    assert tstate.CLIENT_GROUPS == jstate.CLIENT_GROUPS
    assert tstate.OPT_MOMENT_KEYS == jstate.OPT_MOMENT_KEYS
    for b in tstate.REGISTRY:
        assert b.stacked == jstate.block(b.name).stacked, b.name
    with pytest.raises(KeyError, match="unregistered"):
        tstate.block("bogus")
    with pytest.raises(KeyError, match="unregistered"):
        tstate.sample_block("bogus", {}, [0])


@pytest.mark.parametrize("name", [b.name for b in tstate.REGISTRY])
def test_block_sample_and_scatter_match_reference(name):
    full = _state(1)
    value = full[name]
    idx = [4, 1, 5]
    want = jstate.sample_block(name, jax.tree.map(jnp.asarray, value),
                               jnp.asarray(idx, jnp.int32))
    tval = _torch(value)
    got = tstate.sample_block(name, tval, idx)
    _equal(want, _np(got))
    # scatter a changed sub back (every leaf moved, ints and floats)
    sub = jax.tree.map(lambda x: x + np.asarray(100, x.dtype), _np(got))
    want = jstate.scatter_block(name, jax.tree.map(jnp.asarray, value),
                                jax.tree.map(jnp.asarray, sub),
                                jnp.asarray(idx, jnp.int32))
    before = _np(jax.tree.map(torch.clone, tval))
    out = tstate.scatter_block(name, tval, _torch(sub), torch.tensor(idx))
    _equal(want, _np(out))
    _equal(before, _np(tval))  # the state given is not written
    spec = tstate.block(name)
    if spec.stacked in ("all", "none"):  # "none" replaces wholesale
        pairs = zip(jax.tree.leaves(tval), jax.tree.leaves(out))
    else:
        stacked = [k for k in spec.stacked if k in value]
        pairs = [(a, b) for k in stacked for a, b in
                 zip(jax.tree.leaves(tval[k]), jax.tree.leaves(out[k]))]
    for a, b in pairs:
        assert a.data_ptr() != b.data_ptr()


def test_opt_state_views_keep_shared_step():
    full = _state(3)["opt"]
    idx = [2, 0]
    sub = tstate.sample_block("opt", _torch(full), idx)
    assert int(sub["step"]) == 7
    np.testing.assert_array_equal(sub["mu"]["f_A"]["b"].numpy(),
                                  full["mu"]["f_A"]["b"][idx])
    sub = dict(sub, step=torch.tensor(9, dtype=torch.int32))
    out = tstate.scatter_block("opt", _torch(full), sub, idx)
    assert int(out["step"]) == 9
    want = jstate.scatter_opt_state(jax.tree.map(jnp.asarray, full),
                                    jax.tree.map(jnp.asarray, _np(sub)),
                                    jnp.asarray(idx, jnp.int32))
    _equal(want, _np(out))


def test_sample_clients_on_models_from_numpy():
    """The federation's own layout: models converted by params_from_numpy
    (hidden layers as lists), ids as a numpy vector."""
    models = _state(4)["models"]
    idx = np.asarray([5, 2])
    got = tstate.sample_clients(params_from_numpy(models, "cpu"), idx)
    want = jstate.sample_clients(jax.tree.map(jnp.asarray, models),
                                 jnp.asarray(idx, jnp.int32))
    _equal(want, _np(got))


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 7), st.integers(0, 1000))
def test_sample_scatter_roundtrip(k, seed):
    """Gather K of C rows, change them, scatter back: the K rows change,
    the others keep their values, as in the reference."""
    rng = np.random.default_rng(seed)
    c = 7
    idx = np.sort(rng.choice(c, k, replace=False))
    tree = {"w": rng.standard_normal((c, 4)).astype(np.float32),
            "n": rng.integers(0, 9, c).astype(np.int32)}
    sub = tstate.sample_clients(_torch(tree), idx)
    sub = {"w": sub["w"] + 1.0, "n": sub["n"] - 1}
    out = _np(tstate.scatter_clients(_torch(tree), sub, idx))
    want = jstate.scatter_clients(jax.tree.map(jnp.asarray, tree),
                                  jax.tree.map(lambda x: jnp.asarray(x.numpy()), sub),
                                  jnp.asarray(idx, jnp.int32))
    _equal(want, out)
    rest = np.setdiff1d(np.arange(c), idx)
    np.testing.assert_array_equal(out["w"][rest], tree["w"][rest])
    np.testing.assert_array_equal(out["w"][idx], tree["w"][idx] + 1.0)
