"""The port's VFL baselines and centralized training
(``repro_torch.core.baselines``: SplitNN, One-Shot VFL, centralized)
against the reference's on the CPU; the aligned vertical rows bit for
bit; every baseline's refusal of the encoders training does not run.

Both sides start from the reference's ``init_client_models(PRNGKey(0),
...)`` weights and draw the same numpy shuffles. Tolerances: final
models within 1e-5 absolute, metric dicts within 1e-3
(``_torch_parity.BASELINE_*``).
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import assert_baseline_close, baseline_pair, baseline_setup
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
    spec, clients, va, te, _, cfg = baseline_setup(False)
    with pytest.raises(NotImplementedError, match="item 17"):
        tb.BASELINES[name](torch.Generator(), spec,
                           EncoderConfig(d_hidden=8, n_layers=1, enc_type=enc_type),
                           clients, va, te, cfg, device="cpu")

