"""Training the transformer encoders in the port's BlendFL federation
against the JAX reference on the CPU. The encoders' gradients run through
flash attention (``FlashAttentionFn``: its forward with the row
log-sum-exp and its backward), on its CPU path (the plain versions).

``Federation`` parity through ``_torch_parity.federation_pair``: smnist,
4 clients, d_hidden 32 with 2 heads (hd = 16, where the attention scale
``1 / sqrt(hd)`` equals the reference's division by ``sqrt(hd)``), one
layer, batch 64, lr 1e-2, 2 rounds from the reference's initial weights
and with its shuffles, for full participation and for SCAFFOLD with 2 of
the 4 clients sampled a round. Tolerances as in
``tests/test_torch_federation.py``: losses rtol 1e-4, omegas atol 1e-3,
params (and SCAFFOLD's control variates) ``PARAM_TOL``. Data seed 1 keeps
every BlendAvg delta of the reference's run 1e-3 from a tie
(``assert_margins``; seed 0 does not).
"""
import pytest

from _torch_parity import (
    assert_federations_close,
    assert_margins,
    assert_round_close,
    assert_stacked_encoder_matches_jax,
    federation_pair,
)

ENC_TYPE = "transformer"
DATA_SEED = 1


@pytest.mark.parametrize("kw", [dict(), dict(strategy="scaffold", n_sampled=2)],
                         ids=["full", "sampled_scaffold"])
def test_federation_tracks_jax(monkeypatch, kw):
    logs, (jf, tf), seen, emas, _ = federation_pair(
        monkeypatch, 2, data_seed=DATA_SEED, enc_type=ENC_TYPE, n_heads=2, **kw)
    assert_margins(seen, emas)
    for jl, tl in logs:
        assert_round_close(jl, tl)
    assert_federations_close(jf, tf)


@pytest.mark.parametrize("n_heads", [2, 4])
def test_stacked_encoder_and_grads_match_jax(n_heads):
    """One stacked application for 3 clients against the reference's
    vmapped encoder: features and every gradient."""
    assert_stacked_encoder_matches_jax(ENC_TYPE, n_heads, seed=n_heads)
