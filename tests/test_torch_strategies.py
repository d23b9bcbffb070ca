"""Aggregation strategies and server optimizers in the port's rounds
against the JAX reference on the CPU: ``Federation`` with fedprox
(mu 0.1 and 0.01), scaffold (full participation, and sampled async with
the adam server optimizer), and the adam and momentum server
optimizers after fedavg and blendavg.

Tolerances are those of ``test_torch_sampling.py``, with two derived
from the arithmetic. The adam server step moves a parameter by
server_lr * m / (sqrt(v) + eps): where the blended delta is small
against eps = 1e-3 this is server_lr * delta / eps, so a difference in
the candidates (held to atol 1e-5) reaches the params multiplied by up
to server_lr / eps = 1000: after an adam step the globals and the
server head are held to atol ADAM_ATOL = 1000 * 1e-5. The blendavg run
with adam takes one round, since a second round's AUROC omegas would
score globals that differ by that much. SCAFFOLD's
update divides the trained weights' difference by steps * lr (about
0.05-0.1 here), which scales the params' 1e-5 by 10-20: its control
variates are held to rtol 1e-4, atol 1e-3. The server optimizer's m,
sqrt(v) and step are held to the tolerance of the blended deltas
(``_torch_parity.server_moments``). Where every participant restarts
from the broadcast global, a delta is what training added, held to the
params' 1e-5 whatever adam did to the globals. In an async round a
straggler's candidate keeps its stale base, so the delta inherits the
difference of the previous global: after an adam step, ADAM_ATOL.
"""
import numpy as np
import pytest

from _torch_parity import (
    assert_federations_close,
    assert_margins,
    assert_round_close,
    federation_pair,
)
from repro_torch.core.aggregate import SERVER_EPS

SCAFFOLD_TOL = dict(rtol=1e-4, atol=1e-3)
ADAM_ATOL = 1.0 / SERVER_EPS * 1e-5  # server_lr / eps * the params' atol


@pytest.mark.parametrize("rounds,data_seed,kw", [
    (2, 0, dict(strategy="fedprox", fedprox_mu=0.1)),
    (2, 0, dict(strategy="fedprox", fedprox_mu=0.01)),
    (2, 0, dict(strategy="scaffold")),
    (3, 0, dict(strategy="scaffold", server_opt="adam", n_sampled=2,
                async_mode=True)),
    (1, 1, dict(server_opt="adam")),
    (2, 0, dict(strategy="fedavg", server_opt="adam")),
    (2, 0, dict(strategy="fedavg", server_opt="momentum")),
], ids=["fedprox_0.1", "fedprox_0.01", "scaffold", "scaffold_adam_async",
        "blendavg_adam", "fedavg_adam", "fedavg_momentum"])
def test_strategy_rounds_track_jax(monkeypatch, rounds, data_seed, kw):
    logs, (jf, tf), seen, *_ = federation_pair(monkeypatch, rounds,
                                              data_seed=data_seed, **kw)
    assert_margins(seen)
    assert bool(seen) == (kw.get("strategy", "blendavg") == "blendavg")
    for jl, tl in logs:
        assert_round_close(jl, tl)
    control = kw.get("strategy") == "scaffold"
    adam = kw.get("server_opt") == "adam"
    adam_tol = dict(rtol=1e-4, atol=ADAM_ATOL)
    assert_federations_close(
        jf, tf, param_tol=adam_tol if adam else None,
        control_tol=SCAFFOLD_TOL if control else None,
        server_tol=adam_tol if adam and kw.get("async_mode") else None)
    if kw.get("server_opt", "none") != "none":
        assert int(tf.strat_state["srv"]["t"]) == rounds
    if control:
        assert set(tf.strat_state) >= {"c_global", "c_local"}
        assert tf.strat_state["c_local"]["f_A"]["in"]["w"].shape[0] == 4
    else:
        assert (tf.strat_state is None) == (kw.get("server_opt", "none") == "none")
