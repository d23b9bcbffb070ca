"""The port's numpy copies of the churn scenarios
(``repro_torch.data.scenario``) and the out-of-core client store
(``repro_torch.data.store``) against the reference's: both example
scenario files parse to the same events and answer every membership and
attack query alike; a store written by either package opens in the
other with the same fingerprint and the same rows; and every
participation policy selects the same ids under a scenario's ``active``
mask. Everything here is numpy on both sides, so it agrees exactly."""
import dataclasses

import numpy as np
import pytest

from repro.core import schedule as jsched
from repro.data import scenario as jscn
from repro.data import store as jstore
from repro_torch.core import schedule as tsched
from repro_torch.data import scenario as tscn
from repro_torch.data import store as tstore

YAMLS = ["examples/scenarios/ci_join.yaml", "examples/scenarios/ci_attack.yaml"]


@pytest.mark.parametrize("path", YAMLS)
def test_scenario_queries_match_reference(path):
    j, t = jscn.load_scenario(path), tscn.load_scenario(path)
    assert [dataclasses.asdict(e) for e in t.events] == \
        [dataclasses.asdict(e) for e in j.events]
    text = open(path).read()
    assert tscn._mini_yaml(text) == jscn._mini_yaml(text)
    assert t.total_joins() == j.total_joins()
    assert t.has_uplink_attacks() == j.has_uplink_attacks()
    t.validate(6)
    for r in range(6):
        te, je = t.events_at(r), j.events_at(r)
        assert (te is None) == (je is None)
        if te is not None:
            assert dataclasses.asdict(te) == dataclasses.asdict(je)
        assert t.n_clients_at(r, 6) == j.n_clients_at(r, 6)
        for q in ("left_ids", "corrupt_ids", "sign_flip_ids", "scale_ids",
                  "backdoor_ids"):
            assert getattr(t, q)(r) == getattr(j, q)(r), q
        np.testing.assert_array_equal(t.active_mask(r, 6, 16), j.active_mask(r, 6, 16))
        ids = np.arange(9)
        coef = t.attack_coef(r, ids)
        assert coef.dtype == np.float32
        np.testing.assert_array_equal(coef, j.attack_coef(r, ids))


def test_scenario_refusals_and_poisoning_match_reference():
    with pytest.raises(ValueError, match="round 1"):
        tscn.Event(round=0)
    with pytest.raises(ValueError, match="only 6 ids"):
        tscn.Scenario((tscn.Event(round=1, leave=(7,)),)).validate(6)
    with pytest.raises(ValueError, match="both sign_flip and scale"):
        tscn.Scenario((tscn.Event(round=1, sign_flip=(1,), scale=(1,)),)).validate(6)
    with pytest.raises(ValueError, match="unknown scenario event keys"):
        tscn.parse_scenario({"events": [{"round": 1, "bogus": 2}]})
    rng = np.random.default_rng(0)
    y = (rng.random((5, 4)) > 0.5).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[0, 3, 1]]
    for kind, lab in (("multilabel", y), ("multiclass", onehot)):
        np.testing.assert_array_equal(tscn.flip_labels(lab, kind),
                                      jscn.flip_labels(lab, kind))
        np.testing.assert_array_equal(tscn.backdoor_target(kind, 4),
                                      jscn.backdoor_target(kind, 4))
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tscn.apply_trigger(x), jscn.apply_trigger(x))
    assert [tscn.backdoor_rows(n) for n in range(6)] == \
        [jscn.backdoor_rows(n) for n in range(6)]


def _clients():
    rng = np.random.default_rng(1)
    out = []
    for n in (3, 0, 5):
        out.append({"partial_a": rng.standard_normal((n, 2, 3)).astype(np.float32),
                    "partial_ya": rng.random((n, 4)).astype(np.float32),
                    "frag_ids_a": np.arange(n, dtype=np.int64)})
    out[1]["frag_b"] = None  # dropped, as the reference drops it
    return out


def _val():
    rng = np.random.default_rng(2)
    return {"val_a": rng.standard_normal((4, 2, 3)).astype(np.float32),
            "val_b": rng.standard_normal((4, 2, 2)).astype(np.float32),
            "val_y": rng.random((4, 4)).astype(np.float32)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_crosses_packages(tmp_path, writer):
    path = str(tmp_path / "store")
    mod = tstore if writer == "port" else jstore
    mod.write_store(path, _clients(), _val(), meta={"task": "t"})
    t, j = tstore.ClientStore(path), jstore.ClientStore(path)
    assert t.fingerprint() == j.fingerprint()
    assert t.manifest == j.manifest and t.n_clients == 3 and t.meta == {"task": "t"}
    for c in range(3):
        assert t.client_keys(c) == j.client_keys(c)
        for k in t.client_keys(c):
            assert t.rows(c, k) == j.rows(c, k)
            np.testing.assert_array_equal(t.shard(c, k).read(), j.shard(c, k).read())
        view = t.client(c)
        assert list(view) == list(j.client(c)) and len(view) == len(j.client(c))
    for k, v in _val().items():
        np.testing.assert_array_equal(t.val()[k], v)
    rows = {"partial_a": [np.array([2, 0]), None, np.array([4])]}
    got, want = t.rows_for_clients([0, 1, 2], rows), j.rows_for_clients([0, 1, 2], rows)
    for a, b in zip(got["partial_a"], want["partial_a"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    # the other package writes the same bytes: same fingerprint
    other = jstore if writer == "port" else tstore
    other.write_store(str(tmp_path / "again"), _clients(), _val(), meta={"task": "t"})
    assert tstore.ClientStore(str(tmp_path / "again")).fingerprint() == t.fingerprint()


def test_store_refusals(tmp_path):
    path = str(tmp_path / "store")
    tstore.write_store(path, _clients(), _val())
    with pytest.raises(FileExistsError):
        tstore.write_store(path, _clients(), _val())
    tstore.write_store(path, _clients()[:2], _val(), overwrite=True)
    assert tstore.ClientStore(path).n_clients == 2
    with pytest.raises(FileNotFoundError, match="import"):
        tstore.ClientStore(str(tmp_path / "missing"))
    with pytest.raises(KeyError, match="val set missing"):
        tstore.write_store(str(tmp_path / "x"), _clients(), {"val_a": 1})


@pytest.mark.parametrize("policy", tsched.POLICIES)
def test_policies_select_alike_under_an_active_mask(policy):
    scn = tscn.load_scenario(YAMLS[0])
    c, k = 16, 3
    tp, jp = tsched.make_policy(policy, c, k), jsched.make_policy(policy, c, k)
    assert tp.needs_state == jp.needs_state
    for r in range(5):
        tel = {"round": r, "rows": np.arange(c, dtype=np.float64),
               "active": scn.active_mask(r, 6, c),
               "omega_ema": np.random.default_rng(r).random(c).astype(np.float32),
               "last_round": np.random.default_rng(r + 9).integers(-1, r + 1, c)}
        trng, jrng = np.random.default_rng([3, r]), np.random.default_rng([3, r])
        got, want = tp.select(trng, tel), jp.select(jrng, tel)
        np.testing.assert_array_equal(got, want)
        assert tel["active"][got].all()
        assert trng.random() == jrng.random()  # the same draws consumed
    with pytest.raises(ValueError, match="active"):
        tp.select(np.random.default_rng(0), {"round": 0, "rows": np.ones(c),
                                             "active": np.zeros(c, bool),
                                             "omega_ema": np.zeros(c),
                                             "last_round": np.zeros(c)})
