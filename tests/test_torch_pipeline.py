"""The port's ``FederatedBatcher`` (``repro_torch.data.pipeline``) against
the reference's: ``build(r, sched)`` is numpy in both and must give
bit-identical host batches (every key, dtypes included) for the same
clients, seed, round and telemetry: full participation, each sampled
policy, a churn scenario and a store-backed loader. Then the port's own
stream: ``rounds()`` with prefetch yields what the synchronous path
yields, state-reading policies take the synchronous path, and ``put``
gives the host values on the CPU."""
import numpy as np
import pytest
import torch

from _torch_parity import reference_federation, sharded_args
from repro.core.federation_sharded import batch_specs as jbatch_specs
from repro.data.store import ClientStore as JClientStore
from repro_torch.core.federation_sharded import batch_specs as tbatch_specs
from repro_torch.data.pipeline import CLIENT_KEYS, FederatedBatcher
from repro_torch.data.store import ClientStore, write_store
from repro_torch.launch import train_federated as ttf


def _same(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _sched(c, seed):
    rng = np.random.default_rng(seed)
    return {"omega_ema": rng.random(c).astype(np.float32),
            "part_count": rng.integers(0, 3, c).astype(np.int32),
            "last_round": rng.integers(-1, 3, c).astype(np.int32)}


BUILDS = {
    "full": [],
    "uniform": ["--n-sampled", "3"],
    "round_robin": ["--n-sampled", "3", "--policy", "round_robin"],
    "data_volume": ["--n-sampled", "2", "--policy", "data_volume"],
    "staleness": ["--n-sampled", "3", "--policy", "staleness"],
    "omega_ema": ["--n-sampled", "3", "--policy", "omega_ema"],
    "ci_join": ["--n-sampled", "3", "--scenario", "examples/scenarios/ci_join.yaml"],
    "ci_attack": ["--n-sampled", "3", "--scenario",
                  "examples/scenarios/ci_attack.yaml", "--policy", "staleness"],
}


@pytest.mark.parametrize("name", list(BUILDS), ids=list(BUILDS))
def test_build_bit_identical_to_reference(name):
    args = sharded_args(*BUILDS[name])
    jspec, jb, _ = reference_federation(args)
    tspec, tb, _, _ = ttf.build_federation(args)
    assert tb.batch_specs().keys() == jb.batch_specs().keys()
    for r in range(4):
        if args.scenario:  # capacity 16 from the join at round 1 on
            if r == 1:
                import dataclasses
                jb.set_spec(dataclasses.replace(jspec, n_clients=16))
                tb.set_spec(dataclasses.replace(tspec, n_clients=16))
        needs = tb.policy is not None and tb.policy.needs_state
        sched = _sched(tb.spec.n_clients, r) if needs else None
        _same(jb.build(r, sched), tb.build(r, sched))
    assert tb.rounds_built == 4 and tb.build_seconds > 0


def test_store_backed_build_bit_identical(tmp_path):
    args = sharded_args("--n-sampled", "3", "--policy", "data_volume")
    jspec, jb, _ = reference_federation(args)
    _, tb, _, _ = ttf.build_federation(args)
    write_store(str(tmp_path / "s"), tb.clients, tb._val_host)
    tstore, jstore = ClientStore(str(tmp_path / "s")), JClientStore(str(tmp_path / "s"))
    ts = FederatedBatcher.from_store(tstore, tb.spec, seed=args.seed)
    js = type(jb).from_store(jstore, jspec, seed=args.seed)
    for r in range(3):
        want = jb.build(r)
        _same(want, js.build(r))
        _same(want, ts.build(r))
    assert ts.store is tstore


def test_batch_specs_match_reference():
    args = sharded_args("--n-sampled", "3", "--scenario",
                        "examples/scenarios/ci_attack.yaml")
    jspec, _, _ = reference_federation(args)
    tspec, _, _, _ = ttf.build_federation(args)
    for ragged in (False, True):
        want, got = jbatch_specs(jspec, ragged), tbatch_specs(tspec, ragged)
        assert list(want) == list(got)
        for k, sds in want.items():
            assert (tuple(sds.shape), str(sds.dtype)) == (got[k][0], str(got[k][1])), k


def test_prefetch_stream_matches_synchronous_path():
    args = sharded_args("--n-sampled", "3")
    _, tb, _, _ = ttf.build_federation(args)
    sync = [(r, b) for r, b in tb.rounds(1, 4, prefetch=0)]
    pre = [(r, b) for r, b in tb.rounds(1, 4, prefetch=2)]
    assert [r for r, _ in sync] == [r for r, _ in pre] == [1, 2, 3]
    for (_, a), (_, b) in zip(sync, pre):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert tb.rounds_built == 6 and tb.stall_seconds >= 0


def test_state_reading_policies_take_the_synchronous_path():
    args = sharded_args("--n-sampled", "3", "--policy", "staleness")
    _, tb, _, _ = ttf.build_federation(args)
    assert tb.policy.needs_state
    with pytest.raises(ValueError, match="telemetry_fn"):
        next(tb.rounds(0, 2))
    with pytest.raises(ValueError, match="sched block"):
        tb.build(0)
    calls = []

    def telemetry():
        calls.append(tb.rounds_built)  # read before each build, not ahead
        return _sched(6, 0)

    rounds = [r for r, _ in tb.rounds(0, 3, prefetch=2, telemetry_fn=telemetry)]
    assert rounds == [0, 1, 2] and calls == [0, 1, 2]


def test_put_on_cpu_gives_the_host_batch():
    args = sharded_args("--n-sampled", "3")
    _, tb, _, _ = ttf.build_federation(args)
    host = tb.build(0)
    dev = tb.put(host)
    assert set(dev) == set(host) | {"val_a", "val_b", "val_y"}
    for k, v in host.items():
        assert dev[k].device.type == "cpu" and dev[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(dev[k].numpy(), v)
        assert dev[k].data_ptr() != torch.from_numpy(v).data_ptr()
    np.testing.assert_array_equal(dev["val_y"].numpy(), tb._val_host["val_y"])


def test_loader_refusals():
    args = sharded_args()
    _, tb, _, _ = ttf.build_federation(args)
    assert set(tb.clients[0]) <= set(CLIENT_KEYS)
    with pytest.raises(ValueError, match="client datasets"):
        FederatedBatcher(tb.clients[:5], tb.spec, tb._val_host)
    with pytest.raises(KeyError, match="unknown client dataset key"):
        FederatedBatcher([dict(c, bogus=np.zeros(1)) for c in tb.clients],
                         tb.spec, tb._val_host)
    with pytest.raises(ValueError, match="requires spec.n_sampled"):
        import dataclasses
        FederatedBatcher(tb.clients, dataclasses.replace(tb.spec, policy="staleness"),
                         tb._val_host)
