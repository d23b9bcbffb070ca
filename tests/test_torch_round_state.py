"""The port's whole-round-state layer (``repro_torch.core.state``: the
registry's every block, ``build_round_state`` / ``init_round_state``,
whole-state ``sample`` / ``scatter``, elastic cohorts and manifest
inspection) against the reference's, on the CPU. Layouts must match in
keys, shapes and dtypes for every codec x strategy x server optimizer;
the cohort operations move values without arithmetic, so both packages
agree bit for bit on the same state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federation_sharded as jfs
from repro.core import state as jstate
from repro_torch.convert import (params_from_numpy, round_state_from_numpy,
                                 round_state_to_numpy)
from repro_torch.core import federation_sharded as tfs
from repro_torch.core import state as tstate

SPEC = dict(n_clients=6, d_hidden=8, n_layers=2, seq_a=3, feat_a=5, seq_b=4,
            feat_b=6, out_dim=3, kind="multiclass", n_partial=4, n_frag=4,
            n_paired=4, n_val=8)


def _layout(tree):
    return [(jax.tree_util.keystr(p), tuple(np.shape(x)), str(np.asarray(x).dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_registry_matches_reference():
    assert [b.name for b in tstate.REGISTRY] == [b.name for b in jstate.REGISTRY]
    for t, j in zip(tstate.REGISTRY, jstate.REGISTRY):
        assert (t.stacked, t.fill, t.optional) == (j.stacked, j.fill, j.optional)
    assert tstate.CAPACITY_BUCKET == jstate.CAPACITY_BUCKET


@pytest.mark.parametrize("codec", ["none", "int8_topk"])
@pytest.mark.parametrize("strategy", ["blendavg", "scaffold"])
@pytest.mark.parametrize("server_opt", ["none", "adam"])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_init_round_state_layout_matches_reference(codec, strategy, server_opt,
                                                   optimizer):
    kw = dict(SPEC, codec=codec, strategy=strategy, server_opt=server_opt,
              optimizer=optimizer, n_sampled=3)
    want = jfs.init_round_state(jax.random.PRNGKey(0), jfs.ShardedFedSpec(**kw))
    got = tfs.init_round_state(torch.Generator(), tfs.ShardedFedSpec(**kw),
                               device="cpu")
    assert _layout(round_state_to_numpy(got)) == _layout(want)
    assert list(got) == [k for k in (b.name for b in tstate.REGISTRY) if k in got]


def _state(seed=0, **kw):
    """The reference's initial round state with noise on every leaf (ints
    shifted), as numpy, so that rows differ."""
    rng = np.random.default_rng(seed)
    spec = jfs.ShardedFedSpec(**dict(SPEC, optimizer="adamw", **kw))
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)).astype(np.float32)
                   if np.asarray(x).dtype.kind == "f"
                   else np.asarray(x) + rng.integers(0, 5, np.shape(x)).astype(np.int32)),
        jfs.init_round_state(jax.random.PRNGKey(0), spec))


STATE_KW = [dict(), dict(codec="int8_topk", strategy="scaffold", server_opt="adam")]


def _equal(want, got):
    assert _layout(want) == _layout(got)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b), np.asarray(a)),
                 want, got)


@pytest.mark.parametrize("kw", STATE_KW, ids=["plain", "codec_scaffold_adam"])
def test_grow_and_retire_match_reference(kw):
    np_state = _state(1, **kw)
    t = round_state_from_numpy(np_state, "cpu")
    j = jax.tree.map(jnp.asarray, np_state)
    grown_j, grown_t = jstate.grow(j, 16), tstate.grow(t, 16)
    assert tstate.state_capacity(grown_t) == jstate.state_capacity(grown_j) == 16
    _equal(jax.tree.map(np.asarray, grown_j), round_state_to_numpy(grown_t))
    assert tstate.grow(t, 6) is t
    with pytest.raises(ValueError, match="cannot shrink"):
        tstate.grow(t, 4)
    want = jax.tree.map(np.asarray, jstate.retire_clients(grown_j, [1, 4, 9]))
    before = round_state_to_numpy(grown_t)
    got = tstate.retire_clients(grown_t, [1, 4, 9])
    _equal(want, round_state_to_numpy(got))
    _equal(before, round_state_to_numpy(grown_t))  # not written in place


@pytest.mark.parametrize("kw", STATE_KW, ids=["plain", "codec_scaffold_adam"])
def test_whole_state_sample_scatter_match_reference(kw):
    np_state = _state(2, **kw)
    t = round_state_from_numpy(np_state, "cpu")
    j = jax.tree.map(jnp.asarray, np_state)
    idx = np.array([5, 0, 2])
    sub_j, sub_t = jstate.sample(j, idx), tstate.sample(t, idx)
    _equal(jax.tree.map(np.asarray, sub_j), round_state_to_numpy(sub_t))
    upd = _state(3, **kw)
    updates_np = jstate.sample(jax.tree.map(jnp.asarray, upd), idx)
    updates_t = tstate.sample(round_state_from_numpy(upd, "cpu"), idx)
    want = jstate.scatter(j, updates_np, idx)
    _equal(jax.tree.map(np.asarray, want),
           round_state_to_numpy(tstate.scatter(t, updates_t, idx)))
    _equal(jax.tree.map(np.asarray, jstate.sample_opt_state(j["opt"], idx)),
           round_state_to_numpy({"opt": tstate.sample_block("opt", t["opt"], idx),
                                 **{k: v for k, v in t.items() if k != "opt"}})["opt"])
    with pytest.raises(KeyError, match="unregistered"):
        tstate.sample(dict(t, bogus=torch.zeros(1)), idx)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 24, 25])
def test_capacity_for_matches_reference(n):
    assert tstate.capacity_for(n) == jstate.capacity_for(n)


def test_capacity_for_refuses_empty():
    with pytest.raises(ValueError):
        tstate.capacity_for(0)


def test_manifest_capacity_matches_reference(tmp_path):
    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.checkpoint import read_manifest

    np_state = _state(4, codec="int8_topk")
    np_state["?stray"] = np.zeros(2, np.float32)
    jsave(str(tmp_path), 1, np_state)
    m = read_manifest(str(tmp_path))
    assert tstate.manifest_capacity(m) == jstate.manifest_capacity(m) == 6
    with pytest.raises(KeyError, match="round-state"):
        tstate.manifest_capacity({"shapes": {}})


def test_build_round_state_matches_reference():
    rng = np.random.default_rng(5)
    groups = {g: {"w": rng.standard_normal((2, 3)).astype(np.float32)}
              for g in tstate.CLIENT_GROUPS}
    stacked = {g: {"w": np.stack([v["w"]] * 4)} for g, v in groups.items()}
    from repro.core import aggregate as jagg
    from repro_torch.core import aggregate as tagg

    want = jstate.build_round_state(
        stacked, groups["g_M"], groups, {"step": np.int32(0)}, {"step": np.int32(0)},
        4, True, jagg.make_strategy("scaffold"))
    t = params_from_numpy({"s": stacked, "g": groups}, "cpu")
    got = tstate.build_round_state(
        t["s"], t["g"]["g_M"], t["g"], {"step": torch.tensor(0, dtype=torch.int32)},
        {"step": torch.tensor(0, dtype=torch.int32)}, 4, True,
        tagg.make_strategy("scaffold"))
    _equal(jax.tree.map(np.asarray, want), round_state_to_numpy(got))


def test_sched_telemetry_and_ema_match_reference():
    from repro.core import schedule as jsched
    from repro_torch.core import schedule as tsched

    _equal(jax.tree.map(np.asarray, jsched.sched_state(5)),
           {k: v.numpy() for k, v in tsched.sched_state(5, "cpu").items()})
    rng = np.random.default_rng(6)
    ema = rng.random(6).astype(np.float32)
    om = rng.random(3).astype(np.float32)
    idx = np.array([4, 0, 2])
    for i, o in ((None, rng.random(6).astype(np.float32)), (idx, om)):
        want = np.asarray(jsched.ema_update(ema, o, 0.9, i))
        got = tsched.ema_update(torch.from_numpy(ema), torch.from_numpy(o), 0.9,
                                None if i is None else torch.from_numpy(i)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    state = {"sched": tsched.sched_state(3, "cpu")}
    tel = tsched.telemetry_from_state(state)
    assert set(tel) == {"omega_ema", "part_count", "last_round"}
    assert tel["last_round"].dtype == np.int32


@pytest.mark.parametrize("stale", [None, [0, 2, 1, 5], [1, 0, 0, 3]])
def test_device_blendavg_matches_reference(stale):
    from repro.core import engine as jeng
    from repro.core.encoders import EncoderConfig as JEnc
    from repro_torch.core import engine as teng
    from repro_torch.core.encoders import EncoderConfig as TEnc
    from repro_torch.kernels.blendavg.ref import blend_error_bound

    rng = np.random.default_rng(7)
    scores = rng.standard_normal(4).astype(np.float32)
    gscore = np.float32(0.1)
    cands = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32)}
    glob = {"w": rng.standard_normal((3, 5)).astype(np.float32)}
    jf = jeng.make_phase_fns(jeng.EngineConfig(JEnc(d_hidden=4), "binary",
                                               blend="reduce"))
    tf = teng.make_phase_fns(teng.EngineConfig(TEnc(d_hidden=4), "binary"))
    kw_j = {"staleness": None if stale is None else np.asarray(stale, np.float32)}
    kw_t = {k: None if v is None else torch.from_numpy(v) for k, v in kw_j.items()}
    want, om_j, up_j = jf.blendavg_update(glob, cands, scores, gscore, **kw_j)
    t = params_from_numpy({"c": cands, "g": glob}, "cpu")
    got, om_t, up_t = tf.blendavg_update(t["g"], t["c"], torch.from_numpy(scores),
                                         torch.tensor(gscore), **kw_t)
    np.testing.assert_allclose(om_t.numpy(), np.asarray(om_j), rtol=0, atol=1e-6)
    assert bool(up_t) == bool(up_j)
    flat = torch.from_numpy(cands["w"].reshape(4, -1))
    ref = torch.from_numpy(np.array(want["w"]).reshape(-1))
    err = (got["w"].reshape(-1) - ref).abs()
    # the reference blends with its own omegas: their difference from the
    # port's, times |x|, adds to the sum-order bound
    d_om = (om_t - torch.from_numpy(np.array(om_j))).abs()
    bound = (blend_error_bound(flat, om_t, ref, got["w"].reshape(-1))
             + (d_om[:, None] * flat.abs()).sum(0))
    assert bool((err <= bound).all())
