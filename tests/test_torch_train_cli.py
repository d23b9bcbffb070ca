"""The port's LM training CLI (``repro_torch.launch.train``) on the CPU:
its batches against the reference's ``build_batch``, a checkpointed run
resumed to the uninterrupted run's losses, parameters and optimizer
state bit for bit, the legacy params-only restore, its refusals, and a
few steps of every attention family at ``--reduced``.

Sizes: the reduced xlstm-350m (one pair, d 128, vocab 512), batches of
2 x 32 tokens, 6 steps.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch.train import build_batch as jbuild_batch
from repro_torch.checkpoint import load_arrays, save_checkpoint
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import train

from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)

SMALL = ["--batch", "2", "--seq", "32", "--device", "cpu", "--log-every", "1"]


@pytest.mark.parametrize("name", ["xlstm_350m", "qwen2_vl_2b", "whisper_medium"])
def test_build_batch_matches_reference(name):
    """The same numpy stream gives the reference's tokens, labels and (for
    the VLM and the encoder-decoder) inputs, batch after batch."""
    jc, tc = jget(name).reduced(), get_config(name).reduced()
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        want, got = jbuild_batch(jc, 3, 16, jr), train.build_batch(tc, 3, 16, tr)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_resume_equals_uninterrupted_run(tmp_path, capsys):
    full = train.main(SMALL + ["--steps", "6", "--ckpt-every", "3",
                               "--ckpt-dir", str(tmp_path / "a")])
    assert [r["step"] for r in full["history"]] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in full["history"])
    assert all(set(r["launches"].values()) == {0} for r in full["history"])
    # a run that stopped after its step-3 checkpoint, resumed
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train.main(SMALL + ["--steps", "6", "--ckpt-every", "3",
                                  "--ckpt-dir", str(tmp_path / "b")])
    assert "restored step 3 (params + opt_state)" in capsys.readouterr().out
    assert resumed["start"] == 3
    assert [r["step"] for r in resumed["history"]] == [4, 5, 6]
    for a, b in zip(full["history"][3:], resumed["history"]):
        assert a["loss"] == b["loss"] and a["total"] == b["total"]
    for a, b in zip(tree_leaves({"p": full["params"], "o": full["opt_state"]}),
                    tree_leaves({"p": resumed["params"], "o": resumed["opt_state"]})):
        assert torch.equal(a, b)
    assert int(resumed["opt_state"]["step"]) == 6
    want, got = load_arrays(str(tmp_path / "a"), 6), load_arrays(str(tmp_path / "b"), 6)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_legacy_params_only_checkpoint(tmp_path, capsys):
    """A params-only checkpoint restores the params; the optimizer starts
    fresh (its step counts only the steps after the resume), and the run
    says so."""
    first = train.main(SMALL + ["--steps", "2", "--ckpt-every", "100"])
    save_checkpoint(str(tmp_path), 2, first["params"], {"arch": "xlstm-350m"})
    capsys.readouterr()
    same = train.main(SMALL + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert "LEGACY params-only" in capsys.readouterr().out
    assert same["start"] == 2 and same["history"] == []
    for a, b in zip(tree_leaves(first["params"]), tree_leaves(same["params"])):
        assert torch.equal(a, b)
    assert int(same["opt_state"]["step"]) == 0
    assert all(not x.any() for x in tree_leaves(same["opt_state"]["mu"]))
    out = train.main(SMALL + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "100"])
    assert out["start"] == 2 and [r["step"] for r in out["history"]] == [3, 4]
    assert int(out["opt_state"]["step"]) == 2


def test_microbatches_run(capsys):
    out = train.main(SMALL + ["--steps", "2", "--microbatches", "2"])
    assert [r["step"] for r in out["history"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in out["history"])


def test_refusals():
    """--model-parallel above 1 refuses (ROADMAP item 16); the reduced
    phi4-mini, refused before item 15b, now takes a step on the CPU."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        train.main(SMALL + ["--model-parallel", "2"])
    out = train.main(SMALL + ["--arch", "phi4-mini-3.8b", "--steps", "1"])
    assert [r["step"] for r in out["history"]] == [1]
    assert np.isfinite(out["history"][0]["loss"])


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "hymba-1.5b", "qwen2-vl-2b",
                                  "whisper-medium", "deepseek-moe-16b", "dbrx-132b",
                                  "stablelm-3b", "starcoder2-7b", "nemotron-4-15b"])
def test_every_attention_family_takes_steps(arch):
    """Each attention family at --reduced: two steps through the CLI's
    AdamW, finite losses, and on the CPU no kernel launch (the rows count
    the flash kernels and their backward beside the recurrent ones)."""
    out = train.main(SMALL + ["--arch", arch, "--steps", "2"])
    assert [r["step"] for r in out["history"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    for r in out["history"]:
        assert r["launches"] == {k: 0 for k in train.KERNELS}
        assert {"flash_attention", "flash_attention_bwd"} <= set(r["launches"])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium"])
def test_layers_cuts_the_depth(arch):
    """--layers 1 keeps the width and trains the first layer of every
    stack (both of the encoder-decoder's); 0 or more than the model has
    refuses."""
    full = get_config(train.ALIASES.get(arch, arch)).reduced()
    out = train.main(SMALL + ["--arch", arch, "--layers", "1", "--steps", "1"])
    cfg = out["cfg"]
    assert cfg.n_layers == 1 and cfg.d_model == full.d_model
    assert not cfg.is_encdec or cfg.n_enc_layers == 1
    stacks = ("enc_layers", "dec_layers") if cfg.is_encdec else ("layers",)
    for k in stacks:
        assert {x.shape[0] for x in tree_leaves(out["params"][k])} == {1}
    assert np.isfinite(out["history"][0]["loss"])
    for bad in (0, full.n_layers + 1):
        with pytest.raises(ValueError, match="--layers"):
            train.main(SMALL + ["--arch", arch, "--layers", str(bad)])
