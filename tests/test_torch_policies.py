"""The participation policies in the port's sampled rounds against the
JAX reference on the CPU: ``Federation`` with ``n_sampled=2`` of 4
clients under ``round_robin``, ``staleness``, ``omega_ema`` and
``data_volume`` (``uniform`` runs in ``test_torch_sampling.py``).

Both federations draw from ``np.random.default_rng(cfg.seed)`` and
select from their own telemetry, so the ids they sample must be equal in
every round; the state-reading policies (staleness, omega_ema) run async
over 3 rounds, where their telemetry changes. Tolerances are those of
``test_torch_sampling.py``. The omega_ema run's data seed also keeps
every two EMAs it compares equal or at least 1e-3 apart (ROADMAP fault
(d)), so that a last-ulp omega difference cannot reorder its picks.
"""
import numpy as np
import pytest

from _torch_parity import (
    assert_federations_close,
    assert_margins,
    assert_round_close,
    federation_pair,
)


@pytest.mark.parametrize("rounds,data_seed,kw", [
    (2, 1, dict(policy="round_robin")),
    (3, 0, dict(policy="staleness", async_mode=True, lr=0.05)),
    (3, 0, dict(policy="omega_ema", async_mode=True)),
    (2, 1, dict(policy="data_volume")),
], ids=["round_robin", "staleness", "omega_ema", "data_volume"])
def test_policy_rounds_track_jax(monkeypatch, rounds, data_seed, kw):
    logs, (jf, tf), seen, emas, _ = federation_pair(
        monkeypatch, rounds, data_seed=data_seed, n_sampled=2, **kw)
    assert_margins(seen, emas)
    for jl, tl in logs:
        assert_round_close(jl, tl)
    assert_federations_close(jf, tf)
    ids = [tuple(tl["sampled"]) for _, tl in logs]
    if kw["policy"] == "round_robin":  # contiguous (mod C) blocks of K
        assert ids == [(0, 1), (2, 3)]
    if kw["policy"] == "staleness":  # never-synced clients lead
        assert set(ids[1]).isdisjoint(ids[0])
