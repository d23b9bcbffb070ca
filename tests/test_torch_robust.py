"""The Byzantine-robust strategies in the port's rounds against the JAX
reference on the CPU: ``Federation`` at 4 clients with the coordinate
median (4 candidates a modality group and 5 for g_M with the server
head: the mean of the two middle values, then the middle one),
``trimmed_mean`` and ``krum`` at ``n_malicious=1``; and, within the
port, krum at ``n_malicious=0`` against fedavg, bit for bit.

Tolerances are those of ``test_torch_sampling.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_federations_close, assert_round_close, federation_pair
from repro_torch.common.tree import tree_leaves
from repro_torch.core import encoders as tenc
from repro_torch.core import partitioner as tpart
from repro_torch.core.federation import FedConfig, Federation
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("rounds,kw", [
    (2, dict(strategy="median")),
    (2, dict(strategy="trimmed_mean", n_malicious=1)),
    (2, dict(strategy="krum", n_malicious=1)),
    (2, dict(strategy="krum", n_malicious=1, n_sampled=4, async_mode=True)),
], ids=["median", "trimmed_mean", "krum", "krum_sampled"])
def test_robust_rounds_track_jax(monkeypatch, rounds, kw):
    logs, (jf, tf), seen, *_ = federation_pair(monkeypatch, rounds, **kw)
    assert not seen  # no BlendAvg scoring
    assert tf.cfg.strategy == jf.cfg.strategy
    for jl, tl in logs:
        assert_round_close(jl, tl)
        assert len(tl["omega_M"]) == 5
    assert_federations_close(jf, tf)
    assert tf.strat_state is None


def test_krum_without_attackers_is_fedavg_bit_for_bit():
    """n_malicious=0: every candidate survives, and the survivors go
    through the fedavg path: the whole round's globals are equal."""
    spec = tsyn.make_task("smnist")
    tr, va, _ = tsyn.train_val_test(spec, 240, 60, 10, seed=2)
    clients = tpart.partition(tr, 4, seed=3)
    base = FedConfig(n_clients=4, rounds=2, lr=1e-2, batch_size=32,
                     strategy="fedavg")
    feds = [Federation.init(torch.Generator().manual_seed(0), cfg, spec,
                            tenc.EncoderConfig(d_hidden=16, n_layers=1),
                            clients, va, device="cpu")
            for cfg in (base, dataclasses.replace(base, strategy="krum",
                                                  n_malicious=0))]
    for _ in range(2):
        a, b = (f.round() for f in feds)
        for k in ("omega_A", "omega_B", "omega_M"):
            np.testing.assert_array_equal(np.float32(a[k]), b[k])
    for x, y in zip(tree_leaves(feds[0].global_models),
                    tree_leaves(feds[1].global_models)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="krum", n_malicious=2), "krum needs"),
    (dict(strategy="trimmed_mean", n_malicious=2), "trimmed_mean needs"),
    (dict(strategy="median", n_sampled=5), "n_sampled"),
])
def test_robust_cohort_floors_raise(kw, match):
    spec = tsyn.make_task("smnist")
    tr, va, _ = tsyn.train_val_test(spec, 40, 20, 1)
    with pytest.raises(ValueError, match=match):
        cfg = FedConfig(n_clients=4, **kw)
        Federation.init(torch.Generator(), cfg, spec,
                        tenc.EncoderConfig(d_hidden=8, n_layers=1),
                        tpart.partition(tr, 4), va, device="cpu")
