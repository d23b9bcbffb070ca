"""The port's checkpoint store (``repro_torch.checkpoint``): its own
save / restore contract, and round states crossing between the two
packages both ways (the reference's ``save_checkpoint`` read by the
port's ``restore_checkpoint``, and the port's read by the reference's),
with equal keys, shapes, dtypes and values. Values cross without
arithmetic, so they agree bit for bit."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import read_manifest as jread_manifest
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core import federation_sharded as jfs
from repro_torch.checkpoint import (latest_step, read_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.convert import round_state_from_numpy, round_state_to_numpy
from repro_torch.core import federation_sharded as tfs


def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)),
            "hidden": [{"b": torch.arange(4, dtype=torch.float32)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(want[k], got[k])
        elif isinstance(want[k], list):
            for a, b in zip(want[k], got[k]):
                _assert_equal(a, b)
        else:
            assert want[k].dtype == got[k].dtype
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    out = save_checkpoint(str(tmp_path), 3, tree, {"round": 3})
    assert out.endswith("step_00000003") and latest_step(str(tmp_path)) == 3
    m = read_manifest(str(tmp_path), 3)
    assert m["metadata"] == {"round": 3}
    assert m["keys"] == ["hidden/0/b", "step", "w"]
    assert m["dtypes"]["step"] == "int32"
    target = {"w": torch.zeros(3, 2), "hidden": [{"b": torch.zeros(4)}],
              "step": torch.tensor(0, dtype=torch.int32)}
    got = restore_checkpoint(str(tmp_path), target)
    _assert_equal(tree, got)
    assert got["w"].data_ptr() != tree["w"].data_ptr()  # fresh storage
    # an overwrite of the step leaves no .old or .tmp behind
    save_checkpoint(str(tmp_path), 3, dict(tree, w=tree["w"] + 1))
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    torch.testing.assert_close(restore_checkpoint(str(tmp_path), target)["w"],
                               tree["w"] + 1)


def test_stale_tmp_is_swept_and_never_read(tmp_path):
    stale = tmp_path / "step_00000002.tmp"
    stale.mkdir()
    (stale / "arrays.npz").write_text("partial")
    assert latest_step(str(tmp_path)) is None  # .tmp is invisible
    save_checkpoint(str(tmp_path), 2, _tree())
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    # a crashed overwrite's .old copy stays readable
    os.rename(tmp_path / "step_00000002", tmp_path / "step_00000002.old")
    assert latest_step(str(tmp_path)) == 2
    _assert_equal(_tree(), restore_checkpoint(str(tmp_path), _tree()))


def test_duplicate_flattened_keys_refused(tmp_path):
    tree = {"a": {"b": torch.zeros(1)}, "a/b": torch.ones(1)}
    with pytest.raises(ValueError, match="duplicate"):
        save_checkpoint(str(tmp_path), 1, tree)


def test_dtype_kind_mismatch_refused_width_cast(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"last_round": torch.full((3,), -1, dtype=torch.int32),
                                       "x": torch.ones(2, dtype=torch.float64)})
    with pytest.raises(ValueError, match="different kinds"):
        restore_checkpoint(str(tmp_path), {"last_round": torch.zeros(3),
                                           "x": torch.zeros(2)})
    got = restore_checkpoint(str(tmp_path), {
        "last_round": torch.zeros(3, dtype=torch.int32), "x": torch.zeros(2)})
    assert got["x"].dtype == torch.float32  # f64 -> f32 within its kind
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {"last_round": torch.zeros(4, dtype=torch.int32),
                                           "x": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {"y": torch.zeros(2)})


CONFIGS = {
    "plain": dict(),
    "int8_topk": dict(codec="int8_topk", n_sampled=2),
    "scaffold_adam": dict(strategy="scaffold", server_opt="adam", n_sampled=2),
}
SPEC = dict(n_clients=4, d_hidden=8, n_layers=2, seq_a=3, feat_a=5, seq_b=4,
            feat_b=6, out_dim=3, kind="multilabel", n_partial=4, n_frag=4,
            n_paired=4, n_val=8, optimizer="adamw")


def _states(cfg):
    """The reference's initial round state (numpy, with noise on every
    float leaf so that no two leaves are alike) and the port's template
    of the same spec."""
    jspec = jfs.ShardedFedSpec(**SPEC, **cfg)
    rng = np.random.default_rng(1)
    jstate = jax.tree.map(
        lambda x: (np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32)
                   if np.asarray(x).dtype.kind == "f" else np.asarray(x) + 3),
        jfs.init_round_state(jax.random.PRNGKey(0), jspec))
    tstate = tfs.init_round_state(torch.Generator(), tfs.ShardedFedSpec(**SPEC, **cfg),
                                  device="cpu")
    return jstate, tstate


def _manifest_layout(m):
    return m["keys"], m["shapes"], m["dtypes"]


@pytest.mark.parametrize("cfg", list(CONFIGS), ids=list(CONFIGS))
def test_reference_round_state_restores_in_port(tmp_path, cfg):
    jstate, template = _states(CONFIGS[cfg])
    jsave(str(tmp_path), 5, jstate, {"round": 5})
    got = round_state_to_numpy(restore_checkpoint(str(tmp_path), template))
    want_leaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got_leaves = dict((jax.tree_util.keystr(p), v) for p, v in
                      jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_leaves) == len(want_leaves)
    for path, want in want_leaves:
        g = got_leaves[jax.tree_util.keystr(path)]
        assert g.dtype == want.dtype and g.shape == want.shape
        np.testing.assert_array_equal(g, want)
    # the port writes the same layout the reference wrote
    save_checkpoint(str(tmp_path / "port"), 5, round_state_from_numpy(jstate, "cpu"),
                    {"round": 5})
    assert _manifest_layout(read_manifest(str(tmp_path / "port"))) == \
        _manifest_layout(jread_manifest(str(tmp_path)))


@pytest.mark.parametrize("cfg", list(CONFIGS), ids=list(CONFIGS))
def test_port_round_state_restores_in_reference(tmp_path, cfg):
    jstate, _ = _states(CONFIGS[cfg])
    tstate = round_state_from_numpy(jstate, "cpu")
    save_checkpoint(str(tmp_path), 2, tstate)
    template = jax.tree.map(np.zeros_like, jstate)
    got = jrestore(str(tmp_path), template)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b), a)
                 or (np.asarray(b).dtype == a.dtype) or pytest.fail("dtype"),
                 jstate, got)
