"""The port's participation policies (``repro_torch.core.schedule``)
against the reference's, on the CPU.

Each policy, fed its own ``np.random.default_rng`` of one seed and the
same telemetry, must pick the same ids as the reference in every round
of a 5-round run (equal, not close) and leave its generator in the same
state: the sampled rounds of the two federations agree only if both
hold. The telemetry evolves between rounds as a federation moves it
(``last_round`` of the participants, the omega EMA, participation
counts).
"""
import numpy as np
import pytest

from repro.core import schedule as jsched
from repro_torch.core import schedule as tsched

C, K, ROUNDS = 8, 3, 5


def _telemetry(rng):
    return {"round": 0, "last_round": np.full(C, -1, np.int64),
            "omega_ema": np.zeros(C), "part_count": np.zeros(C, np.int64),
            "rows": rng.integers(0, 50, C).astype(np.float64)}


def test_policy_names_and_factory_match():
    assert tsched.POLICIES == jsched.POLICIES
    assert tsched.POOL_FACTOR == jsched.POOL_FACTOR
    with pytest.raises(ValueError, match="unknown participation policy"):
        tsched.make_policy("nope", C, K)
    with pytest.raises(ValueError, match="k="):
        tsched.make_policy("uniform", C, C + 1)
    for name in tsched.POLICIES:
        assert tsched.make_policy(name, C, K).name == name


@pytest.mark.parametrize("name", jsched.POLICIES)
def test_policy_ids_match_reference_over_rounds(name):
    jp, tp = jsched.make_policy(name, C, K), tsched.make_policy(name, C, K)
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    tel = _telemetry(np.random.default_rng(3))
    omega = np.random.default_rng(4)
    for r in range(ROUNDS):
        tel["round"] = r
        want = jp.select(jrng, dict(tel))
        got = tp.select(trng, dict(tel))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert trng.bit_generator.state == jrng.bit_generator.state
        # the round's outcome moves the telemetry, as a federation does
        tel["last_round"] = tel["last_round"].copy()
        tel["last_round"][got] = r
        tel["part_count"] = tel["part_count"] + np.isin(np.arange(C), got)
        ema = tel["omega_ema"].copy()
        ema[got] = 0.9 * ema[got] + 0.1 * omega.random(K)
        tel["omega_ema"] = ema
