"""``launch/specs.py``, ``launch/roofline.py`` and ``launch/dryrun.py``
of the PyTorch port against the reference's ``launch/specs.py`` and
``launch/roofline.py`` on the CPU: the shape table, the skip table, the
production config variant (``one_card_config`` is ``dryrun_config``
without the mesh: the same fields, ``moe_groups`` 1 where the reference
has a group a data shard, no ``act_shard``), the microbatch overrides,
and for all ten architectures the meta-device parameter and decode-cache
specs leaf by leaf, shape and dtype, against the reference's
``jax.eval_shape`` specs, so their bytes are equal; the model FLOPs;
``make_entry``'s train entry (ROADMAP item 15c-1: the reference's
specs, adamw and microbatches) and its prefill / decode functions on a
reduced model; the 40 records of ``dryrun --all`` on the meta device
and the ``--blendfl`` record; the hardware constants ``chip_smoke.py``
holds its bounds to. The train entry's step and its sizing:
``tests/test_torch_lm_train_bf16_step.py``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import roofline as jrl
from repro.launch import specs as JSP
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as SP
from repro_torch.models import backbone as tbb

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _by_path(tree, path=()):
    """{path: (shape, dtype name)} of a tree of meta tensors or
    ShapeDtypeStructs, dict keys sorted as jax orders them."""
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree)
                for p, x in _by_path(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _by_path(v, path + (i,)).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _nbytes(tree):
    return sum(int(np.prod(s)) * np.dtype(d if d != "bfloat16" else np.float16).itemsize
               for s, d in _by_path(tree).values())


def test_shapes_and_overrides_are_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in SP.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSP.SHAPES.items()}
    assert SP.MICROBATCH_OVERRIDES == JSP.MICROBATCH_OVERRIDES
    assert SP.ENC_FRAMES == JSP.ENC_FRAMES
    for arch in ARCH_IDS:
        for shape in SP.SHAPES:
            assert SP.default_microbatches(arch, shape) == JSP.default_microbatches(
                arch, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_variants_are_the_reference_s_without_the_mesh(arch):
    for name, shape in SP.SHAPES.items():
        jshape = JSP.SHAPES[name]
        assert SP.applicability(SP.get_config(arch), shape) == JSP.applicability(
            JSP.get_config(arch), jshape)
        got, want = SP.one_card_config(arch, shape), JSP.dryrun_config(arch, jshape)
        assert (got is None) == (want is None)
        if got is None:
            continue
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert g.pop("act_shard") == ()
        w.pop("act_shard")
        # a group a data shard there: one group on the card's one shard
        assert g.pop("moe_groups") == (1 if w.pop("moe_groups") else 0)
        assert g == w
        assert got.compute_dtype == "bfloat16" and got.param_dtype == "float32"
        assert got.remat == (shape.kind == "train")
        one = SP.one_card_shape(shape)
        assert one.batch == max(1, shape.batch // 16)
        assert SP.one_card_shape(shape, multi_pod=True).batch == max(1, shape.batch // 32)
        assert rl.model_flops(got, shape.kind,
                              one.batch, one.seq) == jrl.model_flops(
            want, jshape.kind, one.batch, one.seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_specs_equal_the_reference_eval_shape(arch):
    """Parameters, and the decode caches of decode_32k and long_500k,
    leaf by leaf (the reference's batch, and the port's one-card share
    for the batch axis), hence byte for byte."""
    shape = SP.SHAPES["decode_32k"]
    got = _by_path(SP.params_specs(SP.one_card_config(arch, shape)))
    want = _by_path(JSP.params_specs(JSP.dryrun_config(arch, JSP.SHAPES["decode_32k"])))
    assert got == want
    n = sum(x.numel() for x in tree_leaves(SP.params_specs(SP.get_config(arch))))
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    for name in ("decode_32k", "long_500k"):
        cfg, jcfg = SP.one_card_config(arch, SP.SHAPES[name]), JSP.dryrun_config(
            arch, JSP.SHAPES[name])
        if cfg is None:
            continue
        got = SP.decode_specs(cfg, SP.SHAPES[name])
        want = JSP.decode_specs(jcfg, JSP.SHAPES[name])
        assert _by_path(got) == _by_path(want)
        assert _nbytes(got["cache"]) == _nbytes(want["cache"])
        one = SP.decode_specs(cfg, SP.one_card_shape(SP.SHAPES[name]))
        assert all(x.device.type == "meta" for x in tree_leaves(one))
        rows = SP.one_card_shape(SP.SHAPES[name]).batch
        assert _nbytes(one["cache"]) * (SP.SHAPES[name].batch // rows) == _nbytes(
            want["cache"])


def test_make_entry_refuses_training_naming_item_15c():
    """Item 15c-1 ported the train entry: at train_4k it builds the
    reference's (``make_entry``'s ``fn(params, opt_state, batch)``), its
    specs the reference's ``jax.eval_shape`` specs leaf by leaf:
    parameters, AdamW's state (f32 moments, an int32 step) and the
    batch; a bf16, remat config at its one-card share."""
    shape = SP.SHAPES["train_4k"]
    for arch in ("phi4_mini_3p8b", "qwen2_vl_2b"):
        cfg = SP.one_card_config(arch, shape)
        assert cfg.remat and cfg.compute_dtype == "bfloat16"
        fn, (p_specs, o_specs, b_specs) = SP.make_entry(
            cfg, SP.one_card_shape(shape), SP.default_microbatches(arch, shape))
        assert callable(fn)
        jfn, (jp, jo, jb), _ = JSP.make_entry(JSP.dryrun_config(arch, shape), shape)
        assert _by_path(p_specs) == _by_path(jp)
        assert _by_path(o_specs) == _by_path(jo)
        assert _by_path(b_specs) == {
            k: ((16,) + v[0][1:], v[1]) for k, v in _by_path(jb).items()}


@pytest.mark.parametrize("arch", ["hymba_1p5b", "deepseek_moe_16b", "whisper_medium"])
def test_entries_run_a_reduced_model_on_the_cpu(arch):
    """The prefill and decode functions of ``make_entry`` on a reduced
    model at a small shape, with ``dryrun.materialize``'s inputs: a bf16
    cache, finite bf16 logits, the decode step into the given cache."""
    cfg = SP.one_card_config(arch, SP.SHAPES["prefill_32k"])
    cfg = cfg.reduced().replace(compute_dtype="bfloat16",
                                moe_groups=cfg.moe_groups)
    pre = SP.ShapeSpec("prefill_small", "prefill", 24, 2)
    fn, (p_specs, b_specs) = SP.make_entry(cfg, pre)
    params, batch = dryrun.materialize(cfg, pre, torch.device("cpu"))
    assert _by_path(p_specs) == _by_path(params)
    assert _by_path(b_specs) == _by_path(batch)
    logits, cache, idx = fn(params, batch)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())
    assert idx == 24 and all(x.dtype in (torch.bfloat16, torch.float32)
                             for x in tree_leaves(cache))
    dec = SP.ShapeSpec("decode_small", "decode", 32, 2)
    fn, specs = SP.make_entry(cfg, dec)
    args = dryrun.materialize(cfg, dec, torch.device("cpu"), params=params)
    assert _by_path(specs[1:3]) == _by_path(args[1:3]) and args[3] == 31
    logits, out = fn(*args)
    assert out is args[2] and bool(torch.isfinite(logits.float()).all())


def test_dryrun_all_sizes_forty_entries_on_the_meta_device(capsys):
    records = dryrun.main(["--all"])
    assert len(records) == 40
    assert {r["status"] for r in records} <= {"ok", "skip", "does_not_fit"}
    by = {(r["arch"], r["shape"]): r for r in records}
    assert by[("whisper_medium", "long_500k")]["status"] == "skip"
    phi = by[("phi4_mini_3p8b", "decode_32k")]
    assert phi["status"] == "ok" and (phi["batch"], phi["seq"]) == (8, 32768)
    assert phi["cache_bytes"] == 32 * 2 * 8 * 32768 * 8 * 128 * 2
    assert phi["roofline"]["bottleneck"] == "memory"
    assert by[("phi4_mini_3p8b", "prefill_32k")]["roofline"]["bottleneck"] == "compute"
    assert by[("dbrx_132b", "decode_32k")]["status"] == "does_not_fit"
    assert all("entry" in r for (a, s), r in by.items() if s == "train_4k"
               and r["status"] != "skip")
    assert "0 fail / 40 total" in capsys.readouterr().out
    rec = dryrun.main(["--blendfl"])[0]
    assert rec["status"] == "ok" and rec["shape"] == "C16"


def test_roofline_constants_are_the_ones_chip_smoke_uses():
    assert (rl.HBM_BYTES_PER_S, rl.FP32_OPS_PER_S, rl.TF32_OPS_PER_S,
            rl.BF16_OPS_PER_S) == (3.35e12, 67e12, 495e12, 989e12)
    assert chip_smoke.FP32_OPS_PER_S is rl.FP32_OPS_PER_S
    assert chip_smoke.TF32_OPS_PER_S is rl.TF32_OPS_PER_S
    assert chip_smoke.BF16_OPS_PER_S is rl.BF16_OPS_PER_S
    assert chip_smoke.hbm_bytes_per_s is rl.hbm_bytes_per_s
    assert rl.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_bound_counts_no_more_work_than_every_weight_on_every_row(arch):
    """The roofline's weight products (``matmul_flops``: no embedding
    lookups, the head on the logit rows only, experts at top_k / E) stay
    within 2 FLOPs of every parameter on every row (the reference's
    2·N·D with the exact N), full depth and cut to 2 layers, at every
    served shape."""
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        cfg = SP.one_card_config(arch, SP.SHAPES[name])
        if cfg is None:
            continue
        for c in (cfg, dataclasses.replace(cfg, n_layers=2)):
            one = SP.one_card_shape(SP.SHAPES[name])
            params = SP.params_specs(c)
            n = sum(x.numel() for x in tree_leaves(params))
            rows = one.batch * (one.seq if one.kind == "prefill" else 1)
            got = rl.matmul_flops(c, params, one.kind, one.batch, one.seq)
            assert 0 < got <= 2 * n * rows
