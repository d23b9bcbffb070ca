"""Helpers shared by the port's JAX-parity tests (imported by the
``tests/test_torch_*.py`` files that run both frameworks)."""
import jax
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for a module's tests (import it into the test
    module to apply it there). The port's CPU paths of the recurrent
    kernels are many small ops, step by step: with six test workers on
    the same cores, each with a thread a core, their threads contend and
    such a file runs ten to forty times slower than alone. The thread
    count is restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                    n_layers=1, enc_type="mlp", n_heads=4, **kw):
    """The reference's and the port's ``Federation`` side by side for
    ``rounds`` rounds, from the reference's initial weights and with its
    shuffles replayed (``JaxKeyPerms``); ``kw`` goes to both
    ``FedConfig``s (lr 1e-2 unless it says otherwise), ``enc_type`` and
    ``n_heads`` to both ``EncoderConfig``s. Returns (per-round
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
    enc = dict(d_hidden=d_hidden, n_layers=n_layers, enc_type=enc_type,
               n_heads=n_heads)
    jf = JFederation.init(jax.random.PRNGKey(0), JFedConfig(**cfg), spec,
                          jenc.EncoderConfig(**enc),
                          jpart.partition(jtr, n_clients, **FED_SPLIT), jva)
    tf = Federation.init(torch.Generator(), FedConfig(**cfg), spec,
                         tenc.EncoderConfig(**enc),
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


# ------------------------------------------------------ the sharded round --

# The resume lanes' federation (Makefile ci-smoke): smnist, 6 clients,
# 16 rows a phase, d_hidden 16, AdamW at lr 1e-2.
SHARDED_CLI = ["--clients", "6", "--n-train", "384", "--rows-cap", "16",
               "--d-hidden", "16", "--n-val", "64", "--log-every", "0",
               "--device", "cpu"]


def sharded_args(*extra):
    """The port CLI's parsed arguments for the resume lanes' federation
    plus ``extra`` flags."""
    from repro_torch.launch.train_federated import parse_args

    return parse_args(SHARDED_CLI + list(extra))


def reference_federation(args):
    """The reference's spec, batcher and jitted round for CLI ``args``,
    built as its ``train_federated.build_federation`` builds them but
    with no mesh: its ``run`` cannot train a round under jax 0.9 (ROADMAP
    fault (a)), so parity is held against its round function on plain
    unsharded arrays. Returns (spec, batcher, scenario)."""
    from repro.core import state as jrstate
    from repro.core.federation_sharded import ShardedFedSpec
    from repro.core.partitioner import partition
    from repro.data.pipeline import FederatedBatcher
    from repro.data.scenario import load_scenario
    from repro.data.synthetic import make_task, train_val_test
    from repro.launch.train_federated import client_arrays

    task = make_task(args.task)
    tr, va, _ = train_val_test(task, args.n_train, args.n_val, 64,
                               seed=args.data_seed)
    scenario = load_scenario(args.scenario) if args.scenario else None
    n_part = n_cap = args.clients
    if scenario is not None:
        n_part = args.clients + scenario.total_joins()
        n_cap = jrstate.capacity_for(scenario.n_clients_at(-1, args.clients))
    clients = partition(tr, n_part, seed=args.data_seed,
                        dirichlet_alpha=args.dirichlet_alpha)
    rows = max(args.rows_cap, 1)
    spec = ShardedFedSpec(
        n_clients=n_cap, d_hidden=args.d_hidden, n_layers=args.n_layers,
        seq_a=task.seq_a, feat_a=task.feat_a, seq_b=task.seq_b,
        feat_b=task.feat_b, out_dim=task.out_dim, kind=task.kind,
        n_partial=rows, n_frag=rows, n_paired=rows, n_val=args.n_val,
        lr=args.lr, optimizer=args.optimizer, n_sampled=args.n_sampled,
        policy=args.policy, codec=args.codec, topk_frac=args.topk_frac,
        strategy=args.strategy, fedprox_mu=args.fedprox_mu,
        server_opt=args.server_opt, server_lr=args.server_lr,
        n_malicious=args.n_malicious,
        attacks=scenario.has_uplink_attacks() if scenario else False)
    batcher = FederatedBatcher(
        [client_arrays(cd) for cd in clients], spec,
        {"val_a": va.x_a, "val_b": va.x_b, "val_y": va.y}, seed=args.seed,
        prefetch=0, scenario=scenario, n_initial=args.clients)
    return spec, batcher, scenario


def sharded_pair(monkeypatch, args, rounds: int):
    """The reference's and the port's round side by side for ``rounds``
    rounds of the federation CLI ``args`` describe: the port starts from
    the reference's initial round state (``convert``), each side builds
    its batches with its own batcher from its own telemetry (the host
    batches must be bit-identical), and a scenario's joins grow both
    states alike. Returns (per-round (reference metrics, port metrics) as
    numpy, (reference state, port state) as numpy trees, every
    (scores, global score) the port's BlendAvg scored, the omega EMA each
    state-reading selection saw)."""
    import dataclasses

    import torch

    from repro.core import federation_sharded as jfs
    from repro.core import state as jrstate
    from repro.core.schedule import telemetry_from_state as jtelemetry
    from repro_torch.convert import round_state_from_numpy, round_state_to_numpy
    from repro_torch.core import federation_sharded as tfs
    from repro_torch.core import state as trstate
    from repro_torch.core.blendavg import STALENESS_EXP
    from repro_torch.core.schedule import EMA_BETA
    from repro_torch.core.schedule import telemetry_from_state as ttelemetry
    from repro_torch.launch import train_federated as ttf

    seen = []
    make_fns = tfs.make_phase_fns

    def recording_fns(cfg):
        fns = make_fns(cfg)
        update = fns.blendavg_update

        def blendavg_update(glob, cands, scores, gscore, **kw):
            seen.append((scores.numpy().astype(np.float64), float(gscore)))
            return update(glob, cands, scores, gscore, **kw)

        fns.blendavg_update = blendavg_update
        return fns

    monkeypatch.setattr(tfs, "make_phase_fns", recording_fns)
    jspec, jb, scenario = reference_federation(args)
    tspec, tb, tround, device = ttf.build_federation(args)
    # the port's spec has no blend field; it reads the Eq. 9-10 exponent
    # and the omega-EMA decay from module constants, and takes the
    # engine's constant lr and zero decay
    left_out = {"blend": None, "staleness_exp": STALENESS_EXP,
                "ema_beta": EMA_BETA, "schedule": "constant",
                "total_steps": 0, "server_total_steps": 0, "weight_decay": 0.0}
    jd = dataclasses.asdict(jspec)
    assert dataclasses.asdict(tspec) == {k: v for k, v in jd.items()
                                         if k not in left_out}
    assert all(jd[k] == v for k, v in left_out.items() if k != "blend"), jd
    jround = jax.jit(jfs.make_blendfl_round(jspec))
    jstate = jfs.init_round_state(jax.random.PRNGKey(args.seed), jspec)
    tstate = round_state_from_numpy(jax.tree.map(np.asarray, jstate), device)
    needs_state = tb.policy is not None and tb.policy.needs_state
    logs, emas = [], []
    for r in range(rounds):
        if scenario is not None:
            cap = trstate.capacity_for(scenario.n_clients_at(r, args.clients))
            if cap > tspec.n_clients:
                jstate = jrstate.grow(jstate, cap)
                tstate = trstate.grow(tstate, cap)
                jspec = dataclasses.replace(jspec, n_clients=cap)
                tspec = dataclasses.replace(tspec, n_clients=cap)
                jb.set_spec(jspec)
                tb.set_spec(tspec)
                jround = jax.jit(jfs.make_blendfl_round(jspec))
                tround = tfs.make_blendfl_round(tspec)
            ev = scenario.events_at(r)
            if ev is not None and ev.leave:
                jstate = jrstate.retire_clients(jstate, ev.leave)
                tstate = trstate.retire_clients(tstate, ev.leave)
        jsched = jtelemetry(jstate) if needs_state else None
        tsched = ttelemetry(tstate) if needs_state else None
        if needs_state:
            emas.append(np.array(jsched["omega_ema"]))
        jhost, thost = jb.build(r, jsched), tb.build(r, tsched)
        assert jhost.keys() == thost.keys()
        for k in jhost:
            np.testing.assert_array_equal(thost[k], jhost[k], err_msg=k)
            assert thost[k].dtype == jhost[k].dtype, k
        jstate, jm = jround(jstate, jb.put(jhost))
        with torch.no_grad():
            tstate, tm = tround(tstate, tb.put(thost))
        logs.append(({k: np.asarray(v) for k, v in jm.items()},
                     {k: v.numpy() for k, v in tm.items()}))
    return (logs, (jax.tree.map(np.asarray, jstate),
                   round_state_to_numpy(tstate)), seen, emas)


def assert_sharded_round_close(jm, tm):
    """One round's metrics: losses within LOSS_RTOL, omegas within
    OMEGA_ATOL with the same keep-global outcome."""
    assert jm.keys() == tm.keys()
    for k in ("loss_uni", "loss_vfl", "loss_paired"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    for k in ("omega_A", "omega_B", "omega_M"):
        np.testing.assert_allclose(tm[k], jm[k], atol=OMEGA_ATOL, err_msg=k)
        assert (np.sum(tm[k]) == 0) == (np.sum(jm[k]) == 0), k


def assert_sharded_states_close(want, got, lossy=False):
    """Two round states after the same rounds: the same keys, shapes and
    dtypes; the integer leaves (round, last_round, sched's part_count and
    last_round, the optimizer steps) equal; the omega EMA within
    OMEGA_ATOL; every float leaf within PARAM_TOL, or the lossy run-level
    tolerance (ROADMAP fault (a)) under a lossy codec."""
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in wl] == \
        [jax.tree_util.keystr(p) for p, _ in gl]
    floats_w, floats_g = [], []
    for (path, a), (_, b) in zip(wl, gl):
        key = jax.tree_util.keystr(path)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif "omega_ema" in key:
            np.testing.assert_allclose(b, a, atol=OMEGA_ATOL, err_msg=key)
        elif lossy:
            floats_w.append(a)
            floats_g.append(b)
        else:
            np.testing.assert_allclose(b, a, err_msg=key, **PARAM_TOL)
    if lossy:
        lossy_close(floats_w, floats_g)


# ----------------------------------------------------------- baselines --

# The baselines' parity runs: the setup of tests/test_baselines.py
# (smnist, 300/200/200 rows, 3 clients, d_hidden=32, 2 layers, 2 rounds,
# lr 1e-2, batch 64), both sides from the reference's initial weights.
BASELINE_PARAM_ATOL = 1e-5
BASELINE_METRIC_ATOL = 1e-3


def baseline_setup(jax_side: bool, enc_type: str = "mlp"):
    """(spec, clients, val, test, ecfg, cfg) of one package; ``enc_type``
    the encoders' (4 heads of 8 for the recurrent and transformer ones)."""
    if jax_side:
        from repro.core.encoders import EncoderConfig
        from repro.core.federation import FedConfig
        from repro.core.partitioner import partition
        from repro.data.synthetic import make_task, train_val_test
    else:
        from repro_torch.core.encoders import EncoderConfig
        from repro_torch.core.federation import FedConfig
        from repro_torch.core.partitioner import partition
        from repro_torch.data.synthetic import make_task, train_val_test
    spec = make_task("smnist")
    tr, va, te = train_val_test(spec, 300, 200, 200, seed=0)
    return (spec, partition(tr, 3, seed=1), va, te,
            EncoderConfig(d_hidden=32, n_layers=2, enc_type=enc_type),
            FedConfig(n_clients=3, rounds=2, lr=1e-2, batch_size=64, seed=0))


def baseline_pair(monkeypatch, name, history: bool = False,
                  enc_type: str = "mlp"):
    """One baseline run by both packages from the reference's
    ``init_client_models(PRNGKey(0), ...)`` weights. Returns ((metrics,
    history, final models) of the reference, the same of the port); the
    final models are the ones each side passed to its last ``_evaluate``
    (numpy trees)."""
    import importlib

    import torch

    from repro.core.encoders import init_client_models
    from repro_torch.convert import params_to_numpy

    out = []
    for jax_side, mod_name in ((True, "repro.core.baselines"),
                               (False, "repro_torch.core.baselines")):
        # the module, not a function ``repro.core`` exports under its name
        mod = importlib.import_module(mod_name)
        seen = []
        evaluate = mod._evaluate

        def recording(models, *a, _evaluate=evaluate, _np=jax_side, **k):
            seen.append(jax.tree.map(np.asarray, models) if _np
                        else params_to_numpy(models))
            return _evaluate(models, *a, **k)

        monkeypatch.setattr(mod, "_evaluate", recording)
        spec, clients, va, te, ecfg, cfg = baseline_setup(jax_side, enc_type)
        kw = {"history_test": te} if history else {}
        if jax_side:
            base = jax.tree.map(np.asarray, init_client_models(
                jax.random.PRNGKey(0), spec, ecfg))
            res, hist = mod.BASELINES[name](jax.random.PRNGKey(0), spec, ecfg,
                                            clients, va, te, cfg, **kw)
        else:
            res, hist = mod.BASELINES[name](torch.Generator(), spec, ecfg,
                                            clients, va, te, cfg, **kw,
                                            base=base, device="cpu")
        out.append((res, hist, seen[-1]))
    return out


def assert_baseline_close(want, got):
    """Metric dicts and histories within BASELINE_METRIC_ATOL, final
    models within BASELINE_PARAM_ATOL (absolute)."""
    (jres, jhist, jm), (tres, thist, tm) = want, got
    assert sorted(tres) == sorted(jres)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=0,
                                   atol=BASELINE_METRIC_ATOL, err_msg=k)
    assert len(thist) == len(jhist)
    for jh, th in zip(jhist, thist):
        assert sorted(th) == sorted(jh) and th["round"] == jh["round"]
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=0,
                                       atol=BASELINE_METRIC_ATOL, err_msg=k)
    assert_trees_close(jm, tm, rtol=0, atol=BASELINE_PARAM_ATOL)


# ------------------------------------------- training the encoder variants --

def assert_stacked_encoder_matches_jax(enc_type, n_heads, seed, c=3, b=4, s=6,
                                       f=10, d=32):
    """``engine.encoder_apply_stacked`` (one sLSTM or flash call for all C
    clients) against ``jax.vmap`` of the reference's ``encoder_apply``:
    the features and the gradients of sum(features * w) for every
    client's parameters and inputs, within PARAM_TOL. Weights are the
    reference's init of each client plus numpy noise."""
    import torch

    from repro.core import encoders as jenc
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import encoders as tenc
    from repro_torch.core.engine import encoder_apply_stacked

    rng = np.random.default_rng(seed)
    jcfg = jenc.EncoderConfig(d_hidden=d, n_layers=1, enc_type=enc_type,
                              n_heads=n_heads)
    keys = jax.random.split(jax.random.PRNGKey(seed), c)
    p = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(
        x.shape)).astype(np.float32),
        jax.vmap(lambda k: jenc.encoder_init(k, f, jcfg))(keys))
    x = rng.standard_normal((c, b, s, f)).astype(np.float32)
    w = rng.standard_normal((c, b, d)).astype(np.float32)

    def loss(p, x):
        return jax.numpy.sum(jax.vmap(lambda pc, xc: jenc.encoder_apply(pc, xc, jcfg))(
            p, x) * w)

    want_h = jax.vmap(lambda pc, xc: jenc.encoder_apply(pc, xc, jcfg))(p, x)
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(p, x)
    leaves, treedef = jax.tree.flatten(params_from_numpy(p, "cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    tp = jax.tree.unflatten(treedef, leaves)
    tx = torch.from_numpy(x).requires_grad_(True)
    tcfg = tenc.EncoderConfig(d_hidden=d, n_layers=1, enc_type=enc_type,
                              n_heads=n_heads)
    h = encoder_apply_stacked(tp, tx, tcfg)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **PARAM_TOL)
    torch.sum(h * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **PARAM_TOL)
    jax.tree.map(lambda t, g: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(g), **PARAM_TOL), tp, want_p)
