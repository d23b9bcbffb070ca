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


# ------------------------------------------------------------ training --

# The training parity runs: smnist, MLP encoders, batch 64, lr 1e-2
# (the sampled-round and strategy runs: 4 clients, d_hidden=32, one
# hidden layer).
FED_SPLIT = dict(frac_paired=0.4, frac_fragmented=0.3, frac_partial=0.3)
LOSS_RTOL = 1e-4
OMEGA_ATOL = 1e-3
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
DELTA_MARGIN = 1e-3


def federation_pair(monkeypatch, rounds, *, data_seed=0, n_clients=4,
                    n_train=400, n_val=200, n_test=10, d_hidden=32,
                    n_layers=1, **kw):
    """The reference's and the port's ``Federation`` side by side for
    ``rounds`` rounds, from the reference's initial weights and with its
    shuffles replayed (``JaxKeyPerms``); ``kw`` goes to both
    ``FedConfig``s (lr 1e-2 unless it says otherwise). Returns (per-round
    (jax logs, port logs), the two federations, every (scores, global
    score) the reference's BlendAvg scored, the omega EMA each of its
    policy selections saw, the two test sets)."""
    import importlib

    import torch

    from repro.core import encoders as jenc
    from repro.core import partitioner as jpart
    from repro.core.federation import FedConfig as JFedConfig
    from repro.core.federation import Federation as JFederation
    from repro.data import synthetic as jsyn
    from repro_torch.core import encoders as tenc
    from repro_torch.core import partitioner as tpart
    from repro_torch.core.federation import FedConfig, Federation
    from repro_torch.data import synthetic as tsyn

    # the module, not the ``federation`` names that ``repro.core`` exports
    jfed_mod = importlib.import_module("repro.core.federation")
    weights = jfed_mod.blendavg_weights
    seen, emas = [], []

    def recording(scores, global_score, **k):
        seen.append((np.asarray(scores, np.float64), float(global_score)))
        return weights(scores, global_score, **k)

    monkeypatch.setattr(jfed_mod, "blendavg_weights", recording)
    cfg = {"n_clients": n_clients, "rounds": rounds, "lr": 1e-2,
           "batch_size": 64, **kw}
    jtr, jva, jte = jsyn.train_val_test(jsyn.make_task("smnist"), n_train,
                                        n_val, n_test, seed=data_seed)
    spec = tsyn.make_task("smnist")
    ttr, tva, tte = tsyn.train_val_test(spec, n_train, n_val, n_test,
                                        seed=data_seed)
    jf = JFederation.init(jax.random.PRNGKey(0), JFedConfig(**cfg), spec,
                          jenc.EncoderConfig(d_hidden=d_hidden, n_layers=n_layers),
                          jpart.partition(jtr, n_clients, **FED_SPLIT), jva)
    tf = Federation.init(torch.Generator(), FedConfig(**cfg), spec,
                         tenc.EncoderConfig(d_hidden=d_hidden, n_layers=n_layers),
                         tpart.partition(ttr, n_clients, **FED_SPLIT), tva,
                         device="cpu",
                         base=jax.tree.map(np.asarray, jf.global_models),
                         perms=JaxKeyPerms(0))
    select = jf.policy_obj.select

    def recording_select(rng, telemetry):
        emas.append(np.array(telemetry["omega_ema"]))
        return select(rng, telemetry)

    jf.policy_obj.select = recording_select
    logs = [(jf.round(), tf.round()) for _ in range(rounds)]
    return logs, (jf, tf), seen, emas, (jte, tte)


def assert_margins(seen, emas=()):
    """Every BlendAvg delta the reference scored lies at least
    DELTA_MARGIN from 0, and every two omega EMAs a policy compared are
    equal or DELTA_MARGIN apart (ROADMAP fault (d)): so a last-ulp
    difference between the frameworks cannot flip a mask or a pick."""
    for scores, glob in seen:
        d = scores - glob
        assert np.all(np.abs(d[np.isfinite(d)]) >= DELTA_MARGIN), (scores, glob)
    for ema in emas:
        gaps = np.abs(ema[:, None] - ema[None, :])
        assert np.all((gaps == 0) | (gaps >= DELTA_MARGIN)), ema


def assert_round_close(jl, tl):
    """One round's logs: sampled ids equal, losses within LOSS_RTOL (NaN
    on both sides where a phase had no rows), omegas within OMEGA_ATOL
    with the same keep-global outcome."""
    assert jl.keys() == tl.keys()
    if "sampled" in jl:
        np.testing.assert_array_equal(tl["sampled"], np.asarray(jl["sampled"]))
    for k in ("loss_partial", "loss_vfl", "loss_paired"):
        if np.isnan(jl[k]):
            assert np.isnan(tl[k]), k
        else:
            np.testing.assert_allclose(tl[k], jl[k], rtol=LOSS_RTOL)
    for k in ("omega_A", "omega_B", "omega_M"):
        if k in jl:
            want = np.asarray(jl[k])
            np.testing.assert_allclose(tl[k], want, atol=OMEGA_ATOL)
            assert (np.sum(tl[k]) == 0) == (np.sum(want) == 0)


def server_moments(srv):
    """A server optimizer's state as it is compared: m, the step t, and
    adam's v as sqrt(v). m is a weighted sum of the rounds' blended
    deltas (weights summing to 1 - beta1^t), sqrt(v) a weighted L2 norm
    of them (weights summing to 1 - beta2^t), so each moves by at most
    the deltas' difference times (1 - 0.9^t) or sqrt(1 - 0.99^t), both
    below 1/2 for t <= 6: they are held to the tolerance of the deltas.
    v itself, about (1 - beta2) * delta^2, lies below any atol that suits
    the deltas."""
    out = {"m": srv["m"], "t": srv["t"]}
    if "v" in srv:
        out["sqrt_v"] = jax.tree.map(np.sqrt, srv["v"])
    return out


def assert_federations_close(jf, tf, lossy=False, param_tol=None,
                             control_tol=None, server_tol=None):
    """The state two federations hold after the same rounds: global
    params and the server head within ``param_tol`` (default PARAM_TOL;
    under a lossy codec the run-level tolerance of ROADMAP fault (a)),
    ``last_round`` and ``part_count`` equal, ``omega_ema`` within
    OMEGA_ATOL, SCAFFOLD's control variates within ``control_tol`` and
    the server optimizer's moments (``server_moments``) within
    ``server_tol`` (both default PARAM_TOL)."""
    from repro_torch.convert import params_to_numpy

    def close(want, got, tol):
        if lossy:
            lossy_close(want, got)
        else:
            assert_trees_close(want, got, **tol)

    close(jax.tree.map(np.asarray, jf.global_models),
          params_to_numpy(tf.global_models), param_tol or PARAM_TOL)
    close(jax.tree.map(np.asarray, jf.server_gmv),
          params_to_numpy(tf.server_gmv), param_tol or PARAM_TOL)
    np.testing.assert_array_equal(tf.last_round, jf.last_round)
    np.testing.assert_array_equal(tf.part_count, jf.part_count)
    np.testing.assert_allclose(tf.omega_ema, jf.omega_ema, atol=OMEGA_ATOL)
    assert tf.round_no == jf.round_no
    if jf.strat_state is None:
        assert tf.strat_state is None
        return
    want = jax.tree.map(np.asarray, jf.strat_state)
    got = jax.tree.map(lambda x: x.numpy(), tf.strat_state)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    control = [k for k in ("c_global", "c_local") if k in want]
    close({k: want[k] for k in control}, {k: got[k] for k in control},
          control_tol or PARAM_TOL)
    if "srv" in want:
        close(server_moments(want["srv"]), server_moments(got["srv"]),
              server_tol or PARAM_TOL)


def lossy_close(want, got):
    """ROADMAP fault (a): all within 2e-2, at least 99% within 1e-5."""
    d = np.concatenate([np.abs(np.asarray(a) - b).ravel() for a, b in zip(
        jax.tree.leaves(want), jax.tree.leaves(got))])
    assert d.max() <= 2e-2 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())
