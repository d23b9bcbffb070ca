"""The port's sharded round (``repro_torch.core.federation_sharded.
make_blendfl_round``) against the reference's ``make_blendfl_round``
under ``jax.jit`` on plain unsharded arrays (the reference's CLI cannot
train a round under jax 0.9: ROADMAP fault (a)), 3 rounds from the same
converted state on the same host batches (each side's own
``FederatedBatcher``, which must build them bit for bit, from its own
telemetry).

Tolerances: losses rtol 1e-4, omegas atol 1e-3 with the same keep-global
outcome, params rtol 1e-4 / atol 1e-5, the integer state (round,
last_round, sched's part_count and last_round, optimizer steps) equal,
the omega EMA atol 1e-3; under ``int8_topk`` the params take the lossy
run-level tolerance of ROADMAP fault (a). BlendAvg's deltas and every
two omega EMAs a policy compares are held 1e-3 from a tie
(``assert_margins``, fault (d)).

The codec run steps with SGD: AdamW's first step moves every entry by
about +-lr, so every |delta| ties at the top-k threshold and a last-ulp
difference between the frameworks flips the codec's choices wholesale.
This file holds the BlendAvg runs; ``test_torch_sharded_strategies.py``
the score-free ones.
"""
import pytest

from _torch_parity import (assert_margins, assert_sharded_round_close,
                           assert_sharded_states_close, sharded_args,
                           sharded_pair)

RUNS = {
    "full_blendavg_adamw": [],
    "k3_omega_ema_int8_topk": ["--n-sampled", "3", "--policy", "omega_ema",
                               "--codec", "int8_topk", "--optimizer", "sgd",
                               "--lr", "0.1", "--data-seed", "1"],
}


@pytest.mark.parametrize("run", list(RUNS), ids=list(RUNS))
def test_sharded_round_tracks_reference(monkeypatch, run):
    flags = RUNS[run]
    logs, (jstate, tstate), seen, emas = sharded_pair(
        monkeypatch, sharded_args(*flags), rounds=3)
    assert seen  # BlendAvg scored every round
    assert_margins(seen, emas)
    for jm, tm in logs:
        assert_sharded_round_close(jm, tm)
    assert_sharded_states_close(jstate, tstate, lossy="--codec" in flags)
    if "--n-sampled" in flags:
        assert (tstate["sched"]["part_count"] > 0).any()
        assert (tstate["last_round"] == -1).any()  # someone sat out
