"""The port's baselines on the recurrent (sLSTM) encoders against the
reference's, on the CPU: the seven of ``repro_torch.core.baselines``
that train them (all but FedMA, whose matching the reference asserts for
the mlp encoders alone).

Both sides start from the reference's ``init_client_models(PRNGKey(0),
...)`` weights (d_hidden 32, 4 heads of 8) and draw the same numpy
shuffles; the port's encoder gradients run ``SLSTMCellFn``'s CPU path.
Tolerances: final models within 1e-5 absolute, metric dicts within 1e-3
(``_torch_parity.BASELINE_*``), as the mlp baselines are held.
"""
import pytest

from _torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_baseline_close, baseline_pair,
    one_torch_thread,
)

SEVEN = ["fedavg", "fedprox", "fednova", "hfcl", "splitnn", "oneshot_vfl",
         "centralized"]


@pytest.mark.parametrize("name", SEVEN)
def test_recurrent_baseline_matches_reference(monkeypatch, name):
    want, got = baseline_pair(monkeypatch, name, enc_type="recurrent")
    assert_baseline_close(want, got)
