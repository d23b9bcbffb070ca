"""The port's sharded round against the reference's under the
score-free strategies (see ``test_torch_sharded.py`` for the method and
tolerances): K = 3 of 6 under SCAFFOLD (control variates in the round
state, uniform blend), and K = 3 of 6 under the attacked churn scenario
``examples/scenarios/ci_attack.yaml`` with trimmed_mean (a join crossing
the 8-client capacity bucket, a sign-flipper and a scaler through the
``attack_coef`` uplink hook, the coordinate-wise robust reducer)."""
import numpy as np
import pytest

from _torch_parity import (assert_sharded_round_close,
                           assert_sharded_states_close, sharded_args,
                           sharded_pair)

RUNS = {
    "k3_scaffold": ["--n-sampled", "3", "--strategy", "scaffold"],
    "k3_ci_attack_trimmed_mean": ["--n-sampled", "3", "--scenario",
                                  "examples/scenarios/ci_attack.yaml",
                                  "--strategy", "trimmed_mean"],
}


@pytest.mark.parametrize("run", list(RUNS), ids=list(RUNS))
def test_sharded_round_tracks_reference(monkeypatch, run):
    logs, (jstate, tstate), seen, _ = sharded_pair(
        monkeypatch, sharded_args(*RUNS[run]), rounds=3)
    assert not seen  # no BlendAvg scoring under these strategies
    for jm, tm in logs:
        assert_sharded_round_close(jm, tm)
    assert_sharded_states_close(jstate, tstate)
    if "scaffold" in run:
        assert np.abs(tstate["strat"]["c_global"]["f_A"]["in"]["w"]).max() > 0
    else:  # the join grew the state to the 16-slot bucket
        assert tstate["last_round"].shape == (16,)
