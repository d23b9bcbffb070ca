"""Decentralized serving of the PyTorch port on the recurrent (sLSTM)
and transformer encoders, against the JAX reference on the CPU:
``predict`` on all four routes, the ``ServingEngine`` over request
streams, a JAX checkpoint served by the port, padding rows, and the CLI
selftest on seeded models and on models it trains inline.

Weights are the reference's init plus numpy noise on every leaf, carried
across with ``params_from_numpy``; d_hidden=32 and 4 heads, so hd = 8,
where the attention kernel's scale ``1 / sqrt(hd)`` and the reference's
division by ``sqrt(hd)`` differ by an ulp of a score. Tolerance
(scores), as in ``tests/test_torch_serving.py``:
- codec ``none``: atol=1e-5;
- codec ``int8_topk``: at least 99% of scores within 1e-5 and all within
  2e-2.
Messages and bytes match exactly.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.core import inference as jinf
from repro_torch.core import encoders as tenc
from repro_torch.core import inference as tinf
from repro_torch.data.synthetic import make_task
from repro_torch.launch import serve_federated as tsf

from _torch_parity import (assert_scores_close, engine_matches_jax_engine,
                           predict_matches_jax, serving_models, serving_requests)


@pytest.fixture(scope="module", params=["recurrent", "transformer"])
def variant(request):
    """Noisy reference weights of the recurrent (sLSTM) or transformer
    encoders at d_hidden=32, 4 heads (hd = 8), carried to the port."""
    return serving_models("smnist", 32, 1, request.param, seed=7)


@pytest.mark.parametrize("codec", ["none", "int8_topk"])
def test_variant_predict_all_routes_match_jax(variant, codec):
    predict_matches_jax(variant, codec)


@pytest.mark.parametrize("mix,codec", [
    ("mixed_unimodal", "none"), ("vfl_heavy", "none"),
    ("vfl_heavy", "int8_topk")])
def test_variantengine_matches_jax_engine(variant, mix, codec):
    engine_matches_jax_engine(variant, mix, codec)


def test_variant_jax_checkpoint_serves_through_port(variant, tmp_path):
    """``models_from_checkpoint`` builds its shape template for the
    encoder type asked for, and serves the reference's weights."""
    s = variant
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 1, {"global_models": s["np_tree"]["models"],
                              "server_gmv": s["np_tree"]["gmv"]})
    tm, tgmv = tsf.models_from_checkpoint(ckpt, s["spec"], s["tcfg"],
                                          device="cpu")
    for jreq, treq in zip(serving_requests(s["spec"], 6, True), serving_requests(s["spec"], 6, False)):
        c = "int8_topk" if treq.vfl else None
        want = jinf.predict(s["jm"], jreq, s["jcfg"], s["spec"].kind,
                            server_gmv=s["jgmv"], codec=c)
        got = tinf.predict(tm, treq, s["tcfg"], s["spec"].kind,
                           server_gmv=tgmv, codec=c, device="cpu")
        assert_scores_close(got.scores.numpy(), want.scores, c or "none")
    other = "transformer" if s["tcfg"].enc_type == "recurrent" else "recurrent"
    with pytest.raises(KeyError, match="missing leaf"):
        tsf.models_from_checkpoint(ckpt, s["spec"], tenc.EncoderConfig(
            d_hidden=32, n_layers=1, enc_type=other), device="cpu")


def test_variant_padding_rows_leave_live_rows_untouched(variant):
    """Capacity padding and the 2-row floor add rows to a batch; a live
    row's result does not depend on what the other rows hold (the sLSTM
    runs one (row, head) pair a block, attention mixes positions within
    a row only)."""
    s = variant
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (3, s["spec"].seq_a, s["spec"].feat_a)).astype(np.float32))
    fill = torch.from_numpy(rng.standard_normal(
        (5, s["spec"].seq_a, s["spec"].feat_a)).astype(np.float32))
    f = s["tm"]["f_A"]
    padded = tenc.encoder_apply(f, torch.cat([x, torch.zeros_like(fill)]), s["tcfg"])
    noisy = tenc.encoder_apply(f, torch.cat([x, fill]), s["tcfg"])
    assert torch.equal(padded[:3], noisy[:3])
    one = tinf.predict(s["tm"], tinf.InferenceRequest(x[:1].numpy(), None),
                       s["tcfg"], s["spec"].kind, device="cpu")
    two = tinf.predict(s["tm"], tinf.InferenceRequest(
        torch.cat([x[:1], fill[:1]]).numpy(), None), s["tcfg"], s["spec"].kind,
        device="cpu")
    assert torch.equal(one.scores[0], two.scores[0])


@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
def test_serve_driver_selftest_variants_cpu(capsys, enc_type):
    tsf.main(["--selftest", "--enc-type", enc_type, "--train-rounds", "0",
              "--codec", "int8_topk", "--device", "cpu", "--requests", "12",
              "--rows", "10", "--capacities", "2,4,8"])
    out = capsys.readouterr().out
    assert "serving models initialised from seed 0 on cpu" in out
    assert "selftest ok" in out


@pytest.mark.parametrize("enc_type", ["recurrent", "transformer"])
def test_serve_driver_selftest_trains_variants_cpu(capsys, enc_type):
    """``--train-rounds 2`` trains the recurrent and transformer encoders
    inline (their gradients through the autograd functions' CPU paths),
    then serves the blended models."""
    tsf.main(["--selftest", "--enc-type", enc_type, "--train-rounds", "2",
              "--device", "cpu", "--requests", "12", "--rows", "6",
              "--capacities", "2,4,8"])
    out = capsys.readouterr().out
    assert "trained in-process federation: 3 clients, 2 rounds on cpu" in out
    assert "selftest ok" in out
