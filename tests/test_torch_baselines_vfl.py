"""The port's VFL baselines and centralized training
(``repro_torch.core.baselines``: SplitNN, One-Shot VFL, centralized)
against the reference's on the CPU; the aligned vertical rows bit for
bit; every baseline on the recurrent and transformer encoders, FedMA's
refusal of them.

Both sides start from the reference's ``init_client_models(PRNGKey(0),
...)`` weights and draw the same numpy shuffles. Tolerances: final
models within 1e-5 absolute, metric dicts within 1e-3
(``_torch_parity.BASELINE_*``).
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_baseline_close, baseline_pair, baseline_setup,
    one_torch_thread,
)
from repro_torch.core import baselines as tb
from repro_torch.core.encoders import EncoderConfig

jb = importlib.import_module("repro.core.baselines")


@pytest.mark.parametrize("name", ["splitnn", "oneshot_vfl", "centralized"])
def test_vfl_baseline_matches_reference(monkeypatch, name):
    want, got = baseline_pair(monkeypatch, name)
    assert_baseline_close(want, got)


def test_baselines_have_the_reference_keys():
    assert sorted(tb.BASELINES) == sorted(jb.BASELINES)


def test_aligned_vertical_rows_bit_for_bit():
    want = jb._aligned_vertical_rows(baseline_setup(True)[1])
    got = tb._aligned_vertical_rows(baseline_setup(False)[1])
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape and len(a) > 0
        np.testing.assert_array_equal(a, b)


def test_aligned_vertical_rows_without_fragments():
    spec, clients, *_ = baseline_setup(False)
    for c in clients:
        c.frag_b = c.frag_b.empty(spec.seq_b, spec.feat_b, spec.out_dim)
    assert tb._aligned_vertical_rows(clients) is None


@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
@pytest.mark.parametrize("name", sorted(tb.BASELINES))
def test_non_mlp_encoders_are_refused(name, enc_type):
    """FedMA refuses the recurrent and transformer encoders, naming the
    reference's assert; every other baseline trains them (a short CPU
    run, d_hidden 8, one layer, 4 heads of 2) and returns every metric
    key, each NaN or in [0, 1]."""
    spec, clients, va, te, _, cfg = baseline_setup(False)
    ecfg = EncoderConfig(d_hidden=8, n_layers=1, enc_type=enc_type)
    run = lambda: tb.BASELINES[name](torch.Generator(), spec, ecfg, clients, va,
                                     te, cfg, device="cpu")
    if name == "fedma":
        with pytest.raises(NotImplementedError, match="baselines.py:289"):
            run()
        return
    res, hist = run()
    assert sorted(res) == sorted(f"{m}_{k}" for m in ("multimodal", "uni_a", "uni_b")
                                 for k in ("auroc", "auprc"))
    assert hist == []
    for v in res.values():
        assert np.isnan(v) or 0.0 <= v <= 1.0
