"""The xLSTM language model of the PyTorch port against the JAX reference,
on the CPU: configs, blocks, the backbone's forward / prefill / decode,
weights and caches carried across, and the ``serve_lm`` driver.

Only the reduced configs run (``xlstm_350m.reduced()``: one pair, d 128;
``blendfl_paper``: two pairs, d 256); the full xlstm-350m is checked by
arithmetic on shapes, never built. Weights are the reference's init,
carried across with ``params_from_numpy``; the checks against the
reference are ``tests/_torch_lm_parity.py``'s, which every family's
tests share. Tolerances: logits and decode caches within atol 1e-4 /
rtol 1e-4 (f32 sums in another order: the port's CPU path runs the step
recurrences where the reference runs its chunkwise XLA form); greedy
tokens equal wherever the reference's top-2 logit margin exceeds 2e-4.
The port's own consistency checks use the reference test's tolerances
(tests/test_arch_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES as JALIASES
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget
from repro.models import backbone as jbb
from repro.models import blocks as jblocks
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve_lm
from repro_torch.models import backbone as tbb
from repro_torch.models import blocks as tblocks

import _torch_lm_parity as P

NAMES = ("xlstm_350m", "blendfl_paper")


def _cfgs(name):
    jc, tc = jget(name), get_config(name)
    return (jc.reduced(), tc.reduced()) if name == "xlstm_350m" else (jc, tc)


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("name", JARCH_IDS + ["blendfl_paper"])
def test_configs_match_reference(name):
    jc, tc = jget(name), get_config(name)
    for j, t in ((jc, tc), (jc.reduced(), tc.reduced()),
                 (jc.replace(n_layers=4), tc.replace(n_layers=4))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("hd", "is_encdec", "subquadratic", "n_params",
                     "n_active_params"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert str(t.pdtype).split(".")[-1] == np.dtype(j.pdtype).name
        assert str(t.cdtype).split(".")[-1] == np.dtype(j.cdtype).name
    assert ALIASES == JALIASES and ARCH_IDS == JARCH_IDS


def _expected_shapes(cfg) -> dict:
    """Every leaf of an xlstm_pair model, by arithmetic on the config."""
    d, v, h = cfg.d_model, cfg.vocab_size, cfg.n_heads
    ed, n = cfg.ssm_expand * d, cfg.n_layers // 2
    hd = d // h
    return {
        "embed/table": (v, d), "final_norm/g": (d,), "lm_head/w": (d, v),
        "layers/mlstm/ln/g": (n, d), "layers/mlstm/up/w": (n, d, 2 * ed),
        "layers/mlstm/wq/w": (n, ed, ed), "layers/mlstm/wk/w": (n, ed, ed),
        "layers/mlstm/wv/w": (n, ed, ed), "layers/mlstm/wg/w": (n, d, 2 * h),
        "layers/mlstm/wg/b": (n, 2 * h), "layers/mlstm/down/w": (n, ed, d),
        "layers/sln/g": (n, d), "layers/slstm/wx": (n, d, 4 * d),
        "layers/slstm/r": (n, h, hd, 4 * hd),
        "layers/slstm/b": (n, 4 * d), "layers/sdown/w": (n, d, d),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}


def test_full_xlstm_shapes_by_arithmetic():
    """The full xlstm-350m: the reference's leaf shapes (traced, not
    built) are the arithmetic ones the port's blocks use."""
    jc = jget("xlstm_350m")
    shapes = jax.eval_shape(lambda: jbb.init_params(jax.random.PRNGKey(0), jc))
    want = _expected_shapes(get_config("xlstm_350m"))
    assert _flat(shapes) == want
    assert sum(int(np.prod(s)) for s in want.values()) == 405185632
    assert tbb.n_scan_layers(get_config("xlstm_350m")) == 12


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_and_scales_match_reference(name):
    _, tc = _cfgs(name)
    p = tbb.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert _flat(p) == _expected_shapes(tc)
    d = tc.d_model
    assert abs(float(p["layers"]["sdown"]["w"].std()) * np.sqrt(d) - 1) < 0.05
    assert abs(float(p["embed"]["table"].std()) / 0.02 - 1) < 0.05
    assert not p["layers"]["mlstm"]["wg"]["b"].any()
    assert bool((p["final_norm"]["g"] == 1).all())


def test_training_and_grouped_moe_refuse():
    """The attention families train (ROADMAP item 15b: a finite loss and
    a gradient for every leaf; their parity with the reference is in
    tests/test_torch_lm_train_*.py). The grouped MoE dispatch no longer
    refuses: tests/test_torch_lm_moe_grouped.py holds it against the
    reference."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.launch.train import build_batch

    for name in ("phi4_mini_3p8b", "whisper_medium", "hymba_1p5b"):
        cfg = get_config(name).reduced()
        params = tbb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in build_batch(
            cfg, 1, 8, np.random.default_rng(0)).items()}
        total, _, grads = tbb._value_and_grad(params, cfg, batch)
        assert bool(torch.isfinite(total))
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        assert callable(tbb.make_train_step(cfg, None))


# ------------------------------------------------------ against the JAX --

@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    """Reference weights on both sides, a prompt, and the reference's
    forward / prefill / 4 greedy decode steps (``_torch_lm_parity``)."""
    return P.reference_run(request.param, reduce=request.param == "xlstm_350m")


def test_forward_matches_jax(lm):
    P.check_forward(lm)


def test_prefill_logits_and_cache_match_jax(lm):
    P.check_prefill(lm)


def test_greedy_decode_matches_jax(lm):
    P.check_greedy_decode(lm)


def test_decode_from_the_reference_cache(lm):
    P.check_decode_from_reference_cache(lm)


def test_blocks_match_jax(lm):
    """One xlstm pair on its own: block, prefill (output and state) and
    a decode step from that state."""
    jlp = jax.tree.map(lambda x: x[0], lm["jp"]["layers"])
    tlp = jax.tree.map(lambda x: x[0], lm["tp"]["layers"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, lm["jc"].d_model)).astype(np.float32)
    want, _ = jblocks.xlstm_pair_block(jlp, lm["jc"], jnp.asarray(x), None)
    got, _ = tblocks.xlstm_pair_block(tlp, lm["tc"], torch.from_numpy(x), None)
    P.close(got.numpy(), want)
    wy, wst = jblocks.xlstm_pair_prefill(jlp, lm["jc"], jnp.asarray(x), None, 16, None)
    gy, gst = tblocks.xlstm_pair_prefill(tlp, lm["tc"], torch.from_numpy(x), None, 16, None)
    P.close(gy.numpy(), wy)
    P.trees_close(params_to_numpy(gst), wst)
    x1 = x[:, :1]
    wd, wdst = jblocks.xlstm_pair_decode(jlp, lm["jc"], jnp.asarray(x1), wst, 9)
    gd, gdst = tblocks.xlstm_pair_decode(tlp, lm["tc"], torch.from_numpy(x1), gst, 9)
    P.close(gd.numpy(), wd)
    P.trees_close(params_to_numpy(gdst), wdst)


def test_prefill_matches_forward_and_decode_consistent(lm):
    P.check_prefill_matches_forward(lm, decode=True)


def test_serve_lm_generate_matches_jax_greedy(lm):
    P.check_generate(lm)


# ------------------------------------------------------------- the rest --

def test_convert_carries_lm_tree_and_cache():
    """params_from_numpy / params_to_numpy carry the reference's LM tree
    (stacked layers) and its decode cache, sLSTM m at -1e30 included."""
    jc = jget("xlstm_350m").reduced()
    np_p = jax.tree.map(np.asarray, jbb.init_params(jax.random.PRNGKey(3), jc))
    tp = params_from_numpy(np_p, "cpu")
    assert _flat(tp) == _expected_shapes(get_config("xlstm_350m").reduced())
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_p)):
        assert np.array_equal(a, b)
    single = jax.tree.map(np.asarray, jblocks.xlstm_pair_cache(jc, 2, 16, jnp.float32))
    cache = jax.tree.map(lambda x: np.stack([x, x]), single)
    tc = params_from_numpy(cache, "cpu")
    assert float(tc["s"][2].max()) == float(np.float32(-1e30)) and tc["s"][2].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(params_to_numpy(tc)), jax.tree.leaves(cache)):
        assert np.array_equal(a, b)
    port = tbb.init_cache(get_config("xlstm_350m").reduced(), 2, 16, device="cpu")
    want = jbb.init_cache(jc, 2, 16)
    P.trees_close(params_to_numpy(port), want, atol=0)


def test_serve_lm_cli_on_cpu(capsys):
    res = serve_lm.main(["--arch", "xlstm-350m", "--batch", "2",
                         "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 6 tokens x2" in out and "decoded 3 tokens x2" in out
    assert tuple(res["tokens"].shape) == (2, 4)
    sampled = serve_lm.main(["--arch", "blendfl-paper", "--reduced", "--batch", "2",
                             "--prompt-len", "4", "--gen", "2", "--temperature",
                             "0.7", "--device", "cpu"])
    toks = sampled["tokens"]
    assert bool(((toks >= 0) & (toks < 512)).all())
    # the default is the reference's, phi4-mini-3.8b; every family serves
    capsys.readouterr()
    res = serve_lm.main(["--batch", "2", "--prompt-len", "5", "--gen", "2",
                         "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 3)
    assert res["logits"].shape[-1] == get_config("phi4_mini_3p8b").reduced().vocab_size
    for arch in ("qwen2-vl-2b", "whisper-medium", "hymba-1.5b", "dbrx-132b"):
        res = serve_lm.main(["--arch", arch, "--batch", "2", "--prompt-len", "4",
                             "--gen", "2", "--device", "cpu"])
        assert tuple(res["tokens"].shape) == (2, 3)
