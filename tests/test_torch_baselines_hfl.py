"""The port's HFL baselines (``repro_torch.core.baselines``: FedAvg,
FedProx, FedNova, FedMA, HFCL) against the reference's on the CPU, and
FedMA's greedy matcher against the reference's permutation.

Both sides start from the reference's ``init_client_models(PRNGKey(0),
...)`` weights and draw the same numpy shuffles. Tolerances: final
models within 1e-5 absolute, metric dicts and FedAvg's per-round
``history_test`` within 1e-3 (``_torch_parity.BASELINE_*``); the
matcher's permutation exactly.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_baseline_close, baseline_pair
from repro_torch.core import baselines as tb

jb = importlib.import_module("repro.core.baselines")


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "fednova", "fedma", "hfcl"])
def test_hfl_baseline_matches_reference(monkeypatch, name):
    want, got = baseline_pair(monkeypatch, name, history=name == "fedavg")
    assert_baseline_close(want, got)
    if name == "fedavg":
        assert [h["round"] for h in got[1]] == [0, 1]


def _match_inputs(n, seed, case):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((n, n)).astype(np.float32)
    cand = rng.standard_normal((n, n)).astype(np.float32)
    if case == "near":  # cand a noisy, shuffled copy of ref: a real matching
        cand = (ref[rng.permutation(n)]
                + 0.3 * rng.standard_normal((n, n))).astype(np.float32)
    elif case == "duplicated_rows":  # equal rows of sim: ties everywhere
        ref[1::2] = ref[::2]
        cand[n // 2:] = cand[: n // 2]
    elif case == "zero_rows":  # a zero row's similarities are all 0
        ref[: n // 4] = 0
        cand[n // 8: n // 2] = 0
    elif case == "ternary":  # entries in {-1, 0, 1}: many equal cosines
        ref = rng.integers(-1, 2, (n, n)).astype(np.float32)
        cand = rng.integers(-1, 2, (n, n)).astype(np.float32)
        cand[::3] = ref[::3]
    elif case == "all_zero":
        ref[:] = 0
        cand[:] = 0
    return ref, cand


@pytest.mark.parametrize("n,seed,case", [
    (64, 0, "random"), (128, 1, "random"), (64, 2, "near"), (128, 3, "near"),
    (64, 4, "duplicated_rows"), (128, 5, "zero_rows"), (64, 6, "ternary"),
    (16, 7, "all_zero")])
def test_greedy_match_equals_reference(n, seed, case):
    ref, cand = _match_inputs(n, seed, case)
    want = jb._greedy_match(ref, cand)
    got = tb._greedy_match(ref, cand, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


def test_fedma_match_encoder_permutes_like_reference():
    """A member whose hidden units really are shuffled (the parity runs
    above start every client from one model, so their matchings are near
    the identity): the port's ``_match_encoder`` permutes each hidden
    layer's columns and bias as the reference's ``match_encoder`` does."""
    from repro.core.encoders import EncoderConfig, encoder_init
    from repro_torch.convert import params_from_numpy, params_to_numpy

    rng = np.random.default_rng(9)
    f = jax.tree.map(np.asarray, encoder_init(jax.random.PRNGKey(3), 6,
                                              EncoderConfig(d_hidden=32, n_layers=2)))
    g = jax.tree.map(np.copy, f)
    for layer in g["hidden"]:
        p = rng.permutation(32)
        layer["w"] = (layer["w"][:, p] + 0.05 * rng.standard_normal(
            layer["w"].shape)).astype(np.float32)
        layer["b"] = layer["b"][p]
    got = params_to_numpy(tb._match_encoder(
        [layer["w"].copy() for layer in f["hidden"]], params_from_numpy(g, "cpu")))
    for li, layer in enumerate(g["hidden"]):  # the reference's loop
        perm = jb._greedy_match(f["hidden"][li]["w"].T, layer["w"].T)
        assert not np.array_equal(perm, np.arange(32))
        np.testing.assert_array_equal(got["hidden"][li]["w"], layer["w"][:, perm])
        np.testing.assert_array_equal(got["hidden"][li]["b"], layer["b"][perm])
    for k in ("in", "norm"):
        jax.tree.map(np.testing.assert_array_equal, got[k], g[k])
