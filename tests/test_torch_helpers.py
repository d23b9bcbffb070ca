"""The port's small shared helpers against the reference's on the CPU:
the stacking helpers of ``repro_torch.common.tree`` and the deprecated
entry points (``local_predict``, ``vfl_server_inference``,
``launch/serve.py``).

Tolerances: the tree helpers copy, so bit for bit; the deprecated wrappers return exactly what ``predict`` and
``serve_lm.main`` give.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import serving_models, serving_requests
from repro.common import tree as jtree
from repro_torch.common import tree as ttree
from repro_torch.convert import params_from_numpy
from repro_torch.core import inference as tinf


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [{"in": {"w": mk(4, 3), "b": mk(3)}, "hidden": [{"w": mk(3, 3)},
                                                           {"w": mk(3, 3)}],
             "norm": {"g": mk(3)}, "step": np.int32(7 + i)} for i in range(3)]


CASES = {
    "tree_stack": lambda m, ts: m.tree_stack(ts),
    "tree_index": lambda m, ts: m.tree_index(m.tree_stack(ts), 1),
    "tree_unstack": lambda m, ts: m.tree_unstack(m.tree_stack(ts), 3),
}


def _to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tree_helper_matches_reference(name):
    trees = _trees()
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [params_from_numpy(t, "cpu") for t in trees]
    want = CASES[name](jtree, jt)
    got = CASES[name](ttree, tt)
    w_leaves, w_def = jax.tree.flatten(want)
    g_leaves, g_def = jax.tree.flatten(jax.tree.map(_to_np, got))
    assert w_def == g_def
    for a, b in zip(w_leaves, g_leaves):
        np.testing.assert_array_equal(b, _to_np(a))


@pytest.fixture(scope="module")
def serving():
    return serving_models("smnist", 16, 1, "mlp", seed=1)


def test_local_predict_warns_and_returns_predict(serving):
    s = serving
    for req in serving_requests(s["spec"], 2, False):
        if req.x_a is None and req.x_b is None:
            continue
        with pytest.warns(DeprecationWarning, match="local_predict is deprecated"):
            scores, route = tinf.local_predict(s["tm"], req, s["tcfg"],
                                               s["spec"].kind, device="cpu")
        want = tinf.predict(s["tm"], tinf.InferenceRequest(req.x_a, req.x_b),
                            s["tcfg"], s["spec"].kind, device="cpu")
        assert route == want.route.value != "vfl_fallback"
        np.testing.assert_array_equal(scores.numpy(), want.scores.numpy())


def test_vfl_server_inference_warns_and_returns_predict(serving):
    s = serving
    req = next(r for r in serving_requests(s["spec"], 3, False)
               if r.x_a is not None and r.x_b is not None)
    with pytest.warns(DeprecationWarning, match="vfl_server_inference is deprecated"):
        scores, messages = tinf.vfl_server_inference(
            s["tm"], s["tgmv"], req, s["tcfg"], s["spec"].kind, device="cpu")
    want = tinf.predict(s["tm"], tinf.InferenceRequest(req.x_a, req.x_b, vfl=True),
                        s["tcfg"], s["spec"].kind, server_gmv=s["tgmv"],
                        device="cpu")
    assert messages == want.messages == 3
    np.testing.assert_array_equal(scores.numpy(), want.scores.numpy())


def test_serve_module_is_the_deprecated_alias_of_serve_lm():
    from repro_torch.launch import serve_lm

    sys.modules.pop("repro_torch.launch.serve", None)
    with pytest.warns(DeprecationWarning, match="moved to repro_torch.launch.serve_lm"):
        serve = importlib.import_module("repro_torch.launch.serve")
    assert serve.main is serve_lm.main
    argv = ["--arch", "xlstm-350m", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--device", "cpu"]
    got, want = serve.main(argv), serve_lm.main(argv)
    assert got["tokens"].shape[0] == 2
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"].numpy())
