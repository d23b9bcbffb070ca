"""Decentralized serving of the PyTorch port against the JAX reference,
on the CPU: ``predict`` on all four routes, the ``ServingEngine`` over
request streams, and a JAX checkpoint served by the port (the recurrent
and transformer encoders: ``tests/test_torch_serving_variants.py``).

Weights are the reference's init plus numpy noise on every leaf, carried
across with ``params_from_numpy``. Tolerance (scores):
- codec ``none``: atol=1e-5;
- codec ``int8_topk``: at least 99% of scores within 1e-5 and all within
  2e-2 — when the encoders differ in the last ulp, the codec can push a
  rare entry across a top-k or rounding boundary.
Messages and bytes match exactly.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.core import inference as jinf
from repro_torch.core import encoders as tenc
from repro_torch.core import inference as tinf
from repro_torch.core import serving as tserv
from repro_torch.checkpoint import latest_step, load_arrays, read_manifest
from repro_torch.launch import serve_federated as tsf

from _torch_parity import (CAPS, assert_scores_close, engine_matches_jax_engine,
                           predict_matches_jax, serving_models, serving_requests)


@pytest.fixture(scope="module", params=[("smnist", 32, 1), ("conditions", 40, 2)],
                ids=["smnist", "conditions"])
def setup(request):
    task, d, layers = request.param
    return serving_models(task, d, layers, "mlp", seed=d)


@pytest.mark.parametrize("codec", ["none", "int8_topk"])
def test_predict_all_routes_match_jax(setup, codec):
    predict_matches_jax(setup, codec)


@pytest.mark.parametrize("mix,codec", [
    ("mixed_unimodal", "none"),  # local routes only: the codec is idle
    ("vfl_heavy", "none"), ("vfl_heavy", "int8_topk")])
def testengine_matches_jax_engine(setup, mix, codec):
    engine_matches_jax_engine(setup, mix, codec)


def test_engine_matches_predict_and_sync_prefetch_agree(setup):
    s = setup
    spec = s["spec"]
    reqs = serving_requests(spec, 4, False)
    runs = []
    for prefetch in (0, 2):
        eng = tserv.ServingEngine(
            s["tm"], s["tcfg"], spec.kind, server_gmv=s["tgmv"], device="cpu",
            cfg=tserv.ServingConfig(capacities=CAPS, codec="int8_topk",
                                    window=3, prefetch=prefetch))
        runs.append(eng.run(reqs))
    for a, b, req in zip(*runs, reqs):
        assert torch.equal(a.scores, b.scores)
        ref = tinf.predict(s["tm"], req, s["tcfg"], spec.kind,
                           server_gmv=s["tgmv"], device="cpu",
                           codec="int8_topk" if req.vfl else None)
        assert a.route is ref.route
        assert_scores_close(a.scores.numpy(), ref.scores.numpy(),
                            "int8_topk" if req.vfl else "none")


def test_routing_and_config_validation(setup):
    spec = setup["spec"]
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((3, spec.seq_a, spec.feat_a)).astype(np.float32)
    xb = rng.standard_normal((3, spec.seq_b, spec.feat_b)).astype(np.float32)
    R = tinf.Route
    assert tinf.route_for(tinf.InferenceRequest(xa, xb)) is R.MULTIMODAL
    assert tinf.route_for(tinf.InferenceRequest(xa, None)) is R.UNIMODAL_A
    assert tinf.route_for(tinf.InferenceRequest(None, xb)) is R.UNIMODAL_B
    assert tinf.route_for(tinf.InferenceRequest(xa, xb, vfl=True)) is R.VFL_FALLBACK
    with pytest.raises(ValueError, match="no modality"):
        tinf.route_for(tinf.InferenceRequest(None, None))
    with pytest.raises(ValueError, match="both parties"):
        tinf.route_for(tinf.InferenceRequest(xa, None, vfl=True))
    with pytest.raises(ValueError, match="disagree"):
        tinf.route_for(tinf.InferenceRequest(xa, xb[:2]))
    with pytest.raises(ValueError, match="server_gmv"):
        tinf.predict(setup["tm"], tinf.InferenceRequest(xa, xb, vfl=True),
                     setup["tcfg"], spec.kind, device="cpu")
    for bad in (dict(capacities=(4, 2)), dict(capacities=(1, 4)),
                dict(codec="zip"), dict(window=0), dict(prefetch=-1)):
        with pytest.raises(ValueError):
            tserv.ServingConfig(**bad)
    assert [tserv.bucket_for(n, CAPS) for n in (1, 2, 3, 8)] == [2, 2, 4, 8]
    with pytest.raises(ValueError, match="exceed"):
        tserv.bucket_for(9, CAPS)
    # an assembly error on the worker thread surfaces to the caller
    eng = tserv.ServingEngine(setup["tm"], setup["tcfg"], spec.kind,
                              device="cpu")
    with pytest.raises(ValueError, match="no modality"):
        eng.run([tinf.InferenceRequest(xa, None),
                 tinf.InferenceRequest(None, None)])
    for n in (1, 5):
        for codec in ("none", "int8", "topk", "int8_topk"):
            assert (tinf.communication_cost(n, 64, "vfl", 10, codec=codec)
                    == jinf.communication_cost(n, 64, "vfl", 10, codec=codec))


def test_jax_checkpoint_serves_through_port(setup, tmp_path):
    s = setup
    spec = s["spec"]
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 3, {"global_models": s["np_tree"]["models"],
                              "server_gmv": s["np_tree"]["gmv"],
                              "round": np.int32(3)})
    assert latest_step(ckpt) == 3
    assert read_manifest(ckpt)["shapes"]["server_gmv/out/w"] == [
        s["tcfg"].d_hidden, spec.out_dim]
    assert set(load_arrays(ckpt, 3, prefixes=("round",))) == {"round"}
    tm, tgmv = tsf.models_from_checkpoint(ckpt, spec, s["tcfg"], device="cpu")
    for jreq, treq in zip(serving_requests(spec, 5, True), serving_requests(spec, 5, False)):
        c = "int8_topk" if treq.vfl else None
        want = jinf.predict(s["jm"], jreq, s["jcfg"], spec.kind,
                            server_gmv=s["jgmv"], codec=c)
        got = tinf.predict(tm, treq, s["tcfg"], spec.kind, server_gmv=tgmv,
                           codec=c, device="cpu")
        assert_scores_close(got.scores.numpy(), want.scores,
                            "int8_topk" if treq.vfl else "none")
    wrong = tenc.EncoderConfig(d_hidden=s["tcfg"].d_hidden + 8,
                               n_layers=s["tcfg"].n_layers)
    with pytest.raises(ValueError, match="d_hidden"):
        tsf.models_from_checkpoint(ckpt, spec, wrong, device="cpu")
    deeper = tenc.EncoderConfig(d_hidden=s["tcfg"].d_hidden,
                                n_layers=s["tcfg"].n_layers + 1)
    with pytest.raises(KeyError, match="missing leaf"):
        tsf.models_from_checkpoint(ckpt, spec, deeper, device="cpu")


def test_serve_driver_selftest_cpu(capsys):
    tsf.main(["--selftest", "--codec", "int8_topk", "--device", "cpu",
              "--requests", "16", "--rows", "12", "--capacities", "2,4,8"])
    assert "selftest ok" in capsys.readouterr().out


@pytest.mark.parametrize("rounds,line", [
    ("2", "trained in-process federation: 2 clients, 2 rounds on cpu"),
    ("0", "serving models initialised from seed 0 on cpu")])
def test_serve_driver_trains_inline_unless_zero_rounds(capsys, rounds, line):
    tsf.main(["--selftest", "--device", "cpu", "--train-rounds", rounds,
              "--clients", "2", "--requests", "8", "--rows", "4"])
    out = capsys.readouterr().out
    assert line in out and "selftest ok" in out
