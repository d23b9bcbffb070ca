"""Helpers shared by the port's JAX-parity tests (imported by the
``tests/test_torch_*.py`` files that run both frameworks)."""
import jax
import numpy as np


def jax_perms(key, n_clients: int, n_rows: int) -> np.ndarray:
    """The per-client row orders the reference's phase drivers draw from
    ``key`` (engine.py ``RoundEngine``): one permutation per split key."""
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_rows))(
        jax.random.split(key, n_clients)))


def unimodal_perms(key, n_clients: int, n_rows: int):
    """(modality A, modality B) orders of the reference's unimodal phase."""
    ka, kb = jax.random.split(key)
    return jax_perms(ka, n_clients, n_rows), jax_perms(kb, n_clients, n_rows)


class JaxKeyPerms:
    """A permutation source for ``repro_torch.core.federation`` that
    replays the reference federation's key schedule: ``Federation``
    splits its key once per unimodal and once per paired phase
    (``_next_key``), starting from ``PRNGKey(seed)``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, phase: str, n_clients: int, n_rows: int):
        self.key, sub = jax.random.split(self.key)
        if phase == "unimodal":
            return unimodal_perms(sub, n_clients, n_rows)
        return jax_perms(sub, n_clients, n_rows)


def assert_trees_close(want, got, **tol):
    """Leafwise assert_allclose of a JAX tree against a numpy tree of the
    same structure (lists for the encoders' hidden layers)."""
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **tol), want, got)


# ------------------------------------------------------------- serving --

CAPS = (2, 4, 8)  # the engines' capacity ladder in the serving tests


def assert_scores_close(got, want, codec, flips=None):
    """Scores of one request held to ``serve_federated.within_tolerance``:
    within 1e-5 (codec ``none``); under a lossy codec, with ``flips``
    (rows whose two sends' wire messages differ) every error beyond 1e-5
    in such a row, else all within 2e-2 and at least 99% within 1e-5."""
    from repro_torch.launch.serve_federated import within_tolerance

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = within_tolerance([np.abs(got - want)], codec != "none",
                           None if flips is None else [flips])
    assert tol.ok, tol


def serving_models(task: str, d: int, layers: int, enc_type: str, seed: int) -> dict:
    """The reference's client models and VFL server head plus numpy
    noise on every leaf, on both sides: JAX arrays and the port's
    tensors on the CPU."""
    from repro.core import encoders as jenc
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import encoders as tenc
    from repro_torch.data.synthetic import make_task

    spec = make_task(task)
    jcfg = jenc.EncoderConfig(d_hidden=d, n_layers=layers, enc_type=enc_type)
    tcfg = tenc.EncoderConfig(d_hidden=d, n_layers=layers, enc_type=enc_type)
    rng = np.random.default_rng(seed)
    tree = {"models": jenc.init_client_models(jax.random.PRNGKey(0), spec, jcfg),
            "gmv": jenc.fusion_init(jax.random.PRNGKey(1), d, spec.out_dim)}
    np_tree = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape)).astype(np.float32), tree)
    jax_side = jax.tree.map(jax.numpy.asarray, np_tree)
    torch_side = params_from_numpy(np_tree, "cpu")
    return dict(spec=spec, jcfg=jcfg, tcfg=tcfg, np_tree=np_tree,
                jm=jax_side["models"], jgmv=jax_side["gmv"],
                tm=torch_side["models"], tgmv=torch_side["gmv"])


def serving_requests(spec, seed, jax_side: bool):
    """The same request list for both packages (each its own type)."""
    from repro.core import inference as jinf
    from repro_torch.core import inference as tinf

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


def predict_matches_jax(s, codec):
    """``predict`` of both packages on every route (``s`` from
    ``serving_models``): routes, messages, bytes and scores."""
    from repro.core import inference as jinf
    from repro_torch.core import inference as tinf

    for jreq, treq in zip(serving_requests(s["spec"], 1, True),
                          serving_requests(s["spec"], 1, False)):
        c = codec if treq.vfl else None
        want = jinf.predict(s["jm"], jreq, s["jcfg"], s["spec"].kind,
                            server_gmv=s["jgmv"], codec=c)
        got = tinf.predict(s["tm"], treq, s["tcfg"], s["spec"].kind,
                           server_gmv=s["tgmv"], codec=c, device="cpu")
        assert got.route.value == want.route.value
        assert (got.messages, got.bytes) == (want.messages, want.bytes)
        assert_scores_close(got.scores.numpy(), want.scores,
                            codec if treq.vfl else "none")


def engine_matches_jax_engine(s, mix, codec):
    """Same stream through both engines (rows up to 12 > top capacity 8,
    so requests chunk): scores, routes, per-request and measured bytes.
    The stream is seeded with ``hash(mix)``, salted per process; 24
    requests make a stream without a chunked request (each has 1..12
    rows) about as rare as 1 in 17,000."""
    from repro.core import serving as jserv
    from repro.launch import serve_federated as jsf
    from repro_torch.core import inference as tinf
    from repro_torch.core import serving as tserv
    from repro_torch.launch import serve_federated as tsf

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
    jres = jeng.run(jsf.make_requests(spec, mix, 24, rows=12, seed=3))
    tres = teng.run(tsf.make_requests(spec, mix, 24, rows=12, seed=3))
    assert [r.index for r in tres] == list(range(24))
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
