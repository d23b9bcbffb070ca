"""Decentralized serving of the PyTorch port against the JAX reference,
on the CPU: ``predict`` on all four routes, the ``ServingEngine`` over
request streams, and a JAX checkpoint served by the port.

Weights are the reference's init plus numpy noise on every leaf, carried
across with ``params_from_numpy``. Tolerance (scores):
- codec ``none``: atol=1e-5;
- codec ``int8_topk``: at least 99% of scores within 1e-5 and all within
  2e-2 — when the encoders differ in the last ulp, the codec can push a
  rare entry across a top-k or rounding boundary.
Messages and bytes match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.core import encoders as jenc
from repro.core import inference as jinf
from repro.core import serving as jserv
from repro.launch import serve_federated as jsf
from repro_torch.convert import params_from_numpy
from repro_torch.core import encoders as tenc
from repro_torch.core import inference as tinf
from repro_torch.core import serving as tserv
from repro_torch.checkpoint import latest_step, load_arrays, read_manifest
from repro_torch.data.synthetic import make_task
from repro_torch.launch import serve_federated as tsf

CAPS = (2, 4, 8)


def assert_scores_close(got, want, codec):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    if codec == "none":
        assert err.max() <= 1e-5, err.max()
    else:
        assert err.max() <= 2e-2, err.max()
        assert (err <= 1e-5).mean() >= 0.99, (err <= 1e-5).mean()


@pytest.fixture(scope="module", params=[("smnist", 32, 1), ("conditions", 40, 2)],
                ids=["smnist", "conditions"])
def setup(request):
    task, d, layers = request.param
    spec = make_task(task)
    jcfg = jenc.EncoderConfig(d_hidden=d, n_layers=layers)
    tcfg = tenc.EncoderConfig(d_hidden=d, n_layers=layers)
    rng = np.random.default_rng(d)
    jm = jenc.init_client_models(jax.random.PRNGKey(0), spec, jcfg)
    tree = {"models": jm, "gmv": jenc.fusion_init(jax.random.PRNGKey(1), d,
                                                  spec.out_dim)}
    np_tree = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape)).astype(np.float32), tree)
    jax_side = jax.tree.map(jnp.asarray, np_tree)
    torch_side = params_from_numpy(np_tree, "cpu")
    return dict(spec=spec, jcfg=jcfg, tcfg=tcfg, np_tree=np_tree,
                jm=jax_side["models"], jgmv=jax_side["gmv"],
                tm=torch_side["models"], tgmv=torch_side["gmv"])


def _reqs(spec, seed, jax_side: bool):
    """The same request list for both packages (each its own type)."""
    rng = np.random.default_rng(seed)
    cls = jinf.InferenceRequest if jax_side else tinf.InferenceRequest
    out = []
    for n, a, b, vfl in ((3, 1, 1, 0), (1, 1, 0, 0), (2, 0, 1, 0),
                         (5, 1, 1, 1), (19, 1, 1, 0), (1, 1, 1, 1),
                         (12, 1, 1, 1), (4, 1, 0, 0)):
        xa = rng.standard_normal((n, spec.seq_a, spec.feat_a)).astype(np.float32)
        xb = rng.standard_normal((n, spec.seq_b, spec.feat_b)).astype(np.float32)
        out.append(cls(xa if a else None, xb if b else None, vfl=bool(vfl)))
    return out


@pytest.mark.parametrize("codec", ["none", "int8_topk"])
def test_predict_all_routes_match_jax(setup, codec):
    s = setup
    for jreq, treq in zip(_reqs(s["spec"], 1, True), _reqs(s["spec"], 1, False)):
        c = codec if treq.vfl else None
        want = jinf.predict(s["jm"], jreq, s["jcfg"], s["spec"].kind,
                            server_gmv=s["jgmv"], codec=c)
        got = tinf.predict(s["tm"], treq, s["tcfg"], s["spec"].kind,
                           server_gmv=s["tgmv"], codec=c, device="cpu")
        assert got.route.value == want.route.value
        assert (got.messages, got.bytes) == (want.messages, want.bytes)
        assert_scores_close(got.scores.numpy(), want.scores,
                            codec if treq.vfl else "none")


@pytest.mark.parametrize("mix,codec", [
    ("mixed_unimodal", "none"),  # local routes only: the codec is idle
    ("vfl_heavy", "none"), ("vfl_heavy", "int8_topk")])
def test_engine_matches_jax_engine(setup, mix, codec):
    """Same stream through both engines (rows up to 12 > top capacity 8,
    so requests chunk): scores, routes, per-request and measured bytes."""
    s = setup
    spec = s["spec"]
    jeng = jserv.ServingEngine(s["jm"], s["jcfg"], spec.kind,
                               server_gmv=s["jgmv"],
                               cfg=jserv.ServingConfig(capacities=CAPS,
                                                       codec=codec, window=6))
    teng = tserv.ServingEngine(s["tm"], s["tcfg"], spec.kind,
                               server_gmv=s["tgmv"],
                               cfg=tserv.ServingConfig(capacities=CAPS,
                                                       codec=codec, window=6),
                               device="cpu")
    jres = jeng.run(jsf.make_requests(spec, mix, 12, rows=12, seed=3))
    tres = teng.run(tsf.make_requests(spec, mix, 12, rows=12, seed=3))
    assert [r.index for r in tres] == list(range(12))
    assert max(len(r.scores) for r in tres) > CAPS[-1]  # chunking exercised
    for j, t in zip(jres, tres):
        assert t.route.value == j.route.value
        assert (t.messages, t.bytes) == (j.messages, j.bytes)
        assert_scores_close(t.scores.numpy(), j.scores,
                            codec if t.route is tinf.Route.VFL_FALLBACK else "none")
    for key in ("requests", "rows", "batches", "batches_by_route",
                "wire_messages", "wire_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["wire_bytes"] == sum(r.bytes for r in tres)


def test_engine_matches_predict_and_sync_prefetch_agree(setup):
    s = setup
    spec = s["spec"]
    reqs = _reqs(spec, 4, False)
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
    for jreq, treq in zip(_reqs(spec, 5, True), _reqs(spec, 5, False)):
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
