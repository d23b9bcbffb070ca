"""The port's federated training CLI (``repro_torch.launch.
train_federated``) on the CPU: ``--selftest-resume`` bit for bit on the
Makefile's resume lanes (killed-and-resumed run against the
uninterrupted one, under deterministic algorithms), ``init_or_restore``'s
refusals and capacity migration, the ``import`` subcommand and
``--store-dir``, and a CLI run's per-round history against the
reference's round driven as ``_torch_parity.reference_federation``
builds it (the reference's own CLI cannot train a round under jax 0.9:
ROADMAP fault (a)), both from the reference's initial round state,
which the port's CLI restores from a checkpoint the reference wrote.
The history keeps the scalar metrics: losses rtol 1e-4."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (LOSS_RTOL, SHARDED_CLI, assert_margins,
                           reference_federation, sharded_args)
from repro_torch.checkpoint import read_manifest
from repro_torch.launch import train_federated as ttf

LANE = ["--rounds", "4", "--clients", "6", "--n-sampled", "3",
        "--n-train", "384", "--rows-cap", "16", "--d-hidden", "16",
        "--n-val", "64", "--log-every", "0", "--device", "cpu"]
LANES = {
    "train_federated": ["--rounds", "2", "--clients", "4", "--n-train", "384",
                        "--rows-cap", "16", "--d-hidden", "16", "--n-val", "64",
                        "--log-every", "0", "--device", "cpu"],
    "omega_ema": LANE + ["--policy", "omega_ema"],
    "int8_topk": LANE + ["--codec", "int8_topk"],
    "scaffold": LANE + ["--strategy", "scaffold"],
    "ci_join": LANE + ["--scenario", "examples/scenarios/ci_join.yaml"],
}


@pytest.mark.parametrize("lane", list(LANES), ids=list(LANES))
def test_selftest_resume_bit_exact_on_cpu(lane, capsys):
    assert not torch.are_deterministic_algorithms_enabled()
    ttf.main(["--selftest-resume"] + LANES[lane])
    out = capsys.readouterr().out
    assert "resume parity OK" in out and "bit-identical on cpu" in out
    assert not torch.are_deterministic_algorithms_enabled()  # restored


def _args(*extra):
    return sharded_args("--rounds", "2", "--ckpt-every", "1", *extra)


def test_import_and_store_backed_run(tmp_path, capsys):
    store = str(tmp_path / "store")
    ttf.main(["import", "--store-dir", store] + SHARDED_CLI)
    assert "imported 6 clients" in capsys.readouterr().out
    ckpt = str(tmp_path / "ckpt")
    hist = ttf.main(["--store-dir", store, "--rounds", "2", "--ckpt-dir", ckpt,
                     "--ckpt-every", "1"] + SHARDED_CLI)
    assert [row["round"] for row in hist] == [0, 1]
    assert all(np.isfinite(row["loss_uni"]) for row in hist)
    from repro_torch.data.store import ClientStore

    assert read_manifest(ckpt)["metadata"]["store_fingerprint"] == ClientStore(store).fingerprint()
    # resuming the store-backed run on in-memory data is refused
    args = _args("--ckpt-dir", ckpt)
    spec, batcher, _, device = ttf.build_federation(args)
    with pytest.raises(ValueError, match="store-backed run"):
        ttf.init_or_restore(args, spec, device, ttf._fingerprint(batcher))
    # ... and so is resuming it against another store
    other = str(tmp_path / "other")
    ttf.main(["import", "--store-dir", other, "--data-seed", "1"] + SHARDED_CLI)
    args = _args("--ckpt-dir", ckpt, "--store-dir", other)
    spec, batcher, _, device = ttf.build_federation(args)
    with pytest.raises(ValueError, match="different client store"):
        ttf.init_or_restore(args, spec, device, ttf._fingerprint(batcher))
    # the same store resumes, and trains on
    hist = ttf.main(["--store-dir", store, "--rounds", "3", "--ckpt-dir", ckpt]
                    + SHARDED_CLI)
    assert [row["round"] for row in hist] == [2]


def test_shrinking_capacity_refused_and_growing_migrates(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ttf.main(["--rounds", "2", "--ckpt-dir", ckpt, "--ckpt-every", "2"] + SHARDED_CLI)
    args = _args("--ckpt-dir", ckpt, "--clients", "4")
    spec, _, _, device = ttf.build_federation(args)
    with pytest.raises(ValueError, match="shrinking a cohort"):
        ttf.init_or_restore(args, spec, device)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.federation_sharded import init_round_state

    args = _args("--ckpt-dir", ckpt, "--clients", "9")
    spec, _, _, device = ttf.build_federation(args)
    start, state = ttf.init_or_restore(args, spec, device)
    assert start == 2 and state["last_round"].shape == (9,)
    saved = restore_checkpoint(ckpt, init_round_state(
        torch.Generator(), dataclasses.replace(spec, n_clients=6), "cpu"))
    for key in ("last_round",):
        assert torch.equal(state[key][:6], saved[key])
        assert (state[key][6:] == -1).all()
    w, w0 = state["models"]["f_A"]["in"]["w"], saved["models"]["f_A"]["in"]["w"]
    assert torch.equal(w[:6], w0)
    assert torch.equal(w[6], saved["global_models"]["f_A"]["in"]["w"])
    assert not state["opt"]["mu"]["f_A"]["in"]["w"][6:].any()


def _reference_history(args, rounds):
    """The reference's round on plain arrays from its own init state."""
    from repro.core import federation_sharded as jfs

    jspec, jb, _ = reference_federation(args)
    jround = jax.jit(jfs.make_blendfl_round(jspec))
    state = jfs.init_round_state(jax.random.PRNGKey(args.seed), jspec)
    init = state
    rows = []
    for r in range(rounds):
        state, m = jround(state, jb.put(jb.build(r)))
        rows.append({k: np.asarray(v) for k, v in m.items()})
    return init, rows


@pytest.mark.parametrize("flags", [[], ["--n-sampled", "3", "--policy",
                                        "round_robin", "--strategy", "fedavg"]],
                         ids=["full_blendavg", "k3_round_robin_fedavg"])
def test_cli_history_tracks_reference_driver(tmp_path, monkeypatch, flags):
    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.core import federation_sharded as tfs

    args = sharded_args("--rounds", "3", *flags)
    init, want = _reference_history(args, 3)
    ckpt = str(tmp_path / "ckpt")
    jsave(ckpt, 0, jax.tree.map(np.asarray, init))  # the port resumes it
    seen, make_fns = [], tfs.make_phase_fns

    def recording(cfg):
        fns = make_fns(cfg)
        update = fns.blendavg_update

        def blendavg_update(glob, cands, scores, gscore, **kw):
            seen.append((scores.numpy().astype(np.float64), float(gscore)))
            return update(glob, cands, scores, gscore, **kw)

        fns.blendavg_update = blendavg_update
        return fns

    monkeypatch.setattr(tfs, "make_phase_fns", recording)
    got = ttf.main(SHARDED_CLI + ["--rounds", "3", "--ckpt-dir", ckpt,
                                  "--ckpt-every", "0"] + flags)
    assert_margins(seen)
    assert [row["round"] for row in got] == [0, 1, 2]
    for row, ref in zip(got, want):
        for k in ("loss_uni", "loss_vfl", "loss_paired"):
            np.testing.assert_allclose(row[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
        assert row["launches"] == {"blend_params": 0, "wire_codec": 0}
    assert all(set(row) == {"loss_uni", "loss_vfl", "loss_paired", "round",
                            "launches"} for row in got)


def test_cli_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.main(SHARDED_CLI[:-2] + ["--rounds", "1"])
    assert isinstance(ttf.parse_args([]), argparse.Namespace)
