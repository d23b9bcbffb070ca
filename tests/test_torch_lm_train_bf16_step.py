"""The production variant's train step in the PyTorch port (ROADMAP item
15c-1), on the CPU:

- xlstm-350m at the production numerics (bf16 compute, f32 parameters,
  ``remat``) against the JAX reference, as
  ``tests/test_torch_lm_train_bf16.py`` holds the attention families:
  the loss, every gradient, one AdamW step, ``remat`` bit for bit (the
  mLSTM scan on bf16 inputs cast up, the sLSTM on f32);
- the train step (``make_train_step``: the gradients accumulated into
  one f32 tree, ``adamw``'s ``update_`` and ``apply_updates_``, in
  place) against the out-of-place composition it replaced
  (``out_of_place_step``: ``_value_and_grad``, f32 sums, ``update``,
  ``apply_updates``), bit for bit, at 1 and 8 microbatches, f32 and
  bf16, over two steps: the loss, the parameters and the optimizer
  state; ``update_`` bit for bit ``update`` (AdamW, SGD), and AdamW's
  update against the reference's formula;
- the sizing (``dryrun.held_terms``): its terms for a reduced train
  entry, and the meta-device trace of a layer's saved activations
  against the same layer's on the CPU;
- ``specs.make_entry``'s train entry on a reduced model, one step on the
  CPU with ``dryrun.materialize``'s arguments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_train_bf16_parity as T
from _torch_parity import one_torch_thread  # noqa: F401  (a module fixture)
from repro_torch import optim as topt
from repro import optim as jopt
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as SP
from repro_torch.launch.train import build_batch
from repro_torch.models import backbone as tbb

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def xlstm():
    return T.reference("xlstm_350m")


def test_xlstm_bf16_loss_and_gradients_match_jax(xlstm):
    T.check_loss_and_gradients(xlstm)


def test_xlstm_bf16_adamw_step_matches_jax(xlstm):
    T.check_adamw_step(xlstm)


def test_xlstm_remat_gives_the_same_bits(xlstm):
    T.check_remat_bit_for_bit(xlstm)


def out_of_place_step(cfg, optimizer, microbatches: int = 1):
    """The train step before it stepped in place: each microbatch's
    gradients from ``_value_and_grad``, summed into an f32 tree of zeros
    and divided, then ``update`` and ``apply_updates``, new tensors
    throughout (the reference's step, transcribed)."""
    def train_step(params, opt_state, batch):
        if microbatches > 1:
            parts = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:])) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32),
                             params)
            total = torch.zeros((), dtype=torch.float32)
            for i in range(microbatches):
                t, _, g = tbb._value_and_grad(params, cfg,
                                              {k: v[i] for k, v in parts.items()})
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                total = total + t
            grads = tree_map(lambda g: g / microbatches, grads)
            total = total / microbatches
            metrics = {"loss": total, "aux": torch.zeros_like(total)}
        else:
            total, metrics, grads = tbb._value_and_grad(params, cfg, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (topt.apply_updates(params, updates), opt_state,
                dict(metrics, total=total))

    return train_step


def _two_steps(cfg, microbatches, in_place):
    params = tbb.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    opt = topt.adamw(topt.linear_warmup_cosine(1e-3, warmup=1, total_steps=3))
    step = (tbb.make_train_step if in_place else out_of_place_step)(
        cfg, opt, microbatches=microbatches)
    state = opt.init(params)
    given = tree_leaves(params) + tree_leaves(state)
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(2):
        batch = {k: torch.from_numpy(v) for k, v in build_batch(cfg, 8, 24, rng).items()}
        params, state, metrics = step(params, state, batch)
        losses.append(torch.stack([metrics[k] for k in ("loss", "aux", "total")]))
    out = tree_leaves(params) + tree_leaves(state)
    # in place: the step returns the very tensors it was given
    assert all(a is b for a, b in zip(given, out)) == in_place
    return losses + out


@pytest.mark.parametrize("microbatches", [1, 8])
@pytest.mark.parametrize("name,dtype", [("hymba_1p5b", "bfloat16"),
                                        ("xlstm_350m", "bfloat16"),
                                        ("deepseek_moe_16b", "float32")])
def test_in_place_step_gives_the_out_of_place_bits(name, dtype, microbatches):
    cfg = get_config(name).reduced().replace(compute_dtype=dtype,
                                             remat=dtype == "bfloat16")
    want = _two_steps(cfg, microbatches, in_place=False)
    got = _two_steps(cfg, microbatches, in_place=True)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_in_place_adamw_matches_update_bit_for_bit():
    """``update_`` + ``apply_updates_`` against ``update`` +
    ``apply_updates`` on random trees over three steps of a schedule:
    the same bits, the former returning the state and parameters it was
    given, the latter leaving its inputs as they were."""
    rng = np.random.default_rng(4)

    def tree():
        return {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
                "b": [torch.from_numpy(rng.standard_normal(3).astype(np.float32))]}

    opt = topt.adamw(topt.linear_warmup_cosine(1e-2, warmup=1, total_steps=3))
    p_out = tree()
    p_in = tree_map(torch.clone, p_out)
    s_out, s_in = opt.init(p_out), opt.init(p_in)
    for _ in range(3):
        g = tree()
        kept = [x.clone() for x in tree_leaves(p_out) + tree_leaves(s_out)]
        upd, s_next = opt.update(g, s_out, p_out)
        p_next = topt.apply_updates(p_out, upd)
        assert all(torch.equal(a, b) for a, b in zip(
            kept, tree_leaves(p_out) + tree_leaves(s_out)))
        p_out, s_out = p_next, s_next
        upd_, s_ret = opt.update_(tree_map(torch.clone, g), s_in, p_in)
        assert s_ret is s_in and topt.apply_updates_(p_in, upd_) is p_in
    for a, b in zip(tree_leaves(p_out) + tree_leaves(s_out),
                    tree_leaves(p_in) + tree_leaves(s_in)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="f32"):
        opt.update_(tree_map(torch.Tensor.double, g), s_in, p_in)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_in_place_sgd_matches_update_bit_for_bit(momentum):
    """SGD's ``update_`` + ``apply_updates_`` against ``update`` +
    ``apply_updates`` over three steps of a schedule: the same bits."""
    rng = np.random.default_rng(5)
    opt = topt.sgd(topt.linear_warmup_cosine(1e-2, warmup=1, total_steps=3),
                   momentum=momentum)
    p_out = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))}
    p_in = tree_map(torch.clone, p_out)
    s_out, s_in = opt.init(p_out), opt.init(p_in)
    for _ in range(3):
        g = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))}
        upd, s_out = opt.update(g, s_out, p_out)
        p_out = topt.apply_updates(p_out, upd)
        upd_, s_ret = opt.update_(tree_map(torch.clone, g), s_in, p_in)
        assert s_ret is s_in and topt.apply_updates_(p_in, upd_) is p_in
    for a, b in zip(tree_leaves(p_out) + tree_leaves(s_out),
                    tree_leaves(p_in) + tree_leaves(s_in), strict=True):
        assert torch.equal(a, b)


# AdamW's update against the reference's on the same f32 inputs: 2^-18
# of |u| (one f32 sqrt, divisions and sums on two compilers)
ADAMW_FORMULA_SLACK = 2.0 ** -18


def _adamw_formula_share(**port_kw) -> float:
    """The largest share, over three steps of a schedule, of |u - u_ref|
    in ADAMW_FORMULA_SLACK |u_ref|, where u is the port's ``adamw``
    (``update_``, with ``port_kw`` overriding its arguments) and u_ref
    the reference's, both from the same parameters and gradients:
    normal entries, a fifth of each gradient exactly 0 (0 / (0 + eps))
    and a fifth at 1e-8 (the scale of eps)."""
    rng = np.random.default_rng(6)
    sched = dict(warmup=1, total_steps=10)  # no step at lr 0
    p = {"w": rng.standard_normal((16, 24)).astype(np.float32),
         "b": [rng.standard_normal(24).astype(np.float32)]}
    jo = jopt.adamw(jopt.linear_warmup_cosine(1e-2, **sched))
    kw = dict(lr=topt.linear_warmup_cosine(1e-2, **sched)) | port_kw
    to = topt.adamw(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, p))
    js, ts = jo.init(jp), to.init(tp)
    worst = 0.0
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32)
                         * rng.choice(np.float32([0, 1e-8, 1, 1, 1]), x.shape), p)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update_(tree_map(torch.from_numpy, jax.tree.map(np.copy, g)), ts, tp)
        for want, got in zip(jax.tree.leaves(ju), tree_leaves(tu), strict=True):
            want, got = np.asarray(want), got.numpy()
            if not np.isfinite(got).all():
                return float("inf")
            worst = max(worst, float((np.abs(got - want)
                                      / (ADAMW_FORMULA_SLACK * np.abs(want))).max()))
        topt.apply_updates_(tp, tu)
    return worst


def test_in_place_adamw_matches_the_reference_formula():
    """``update_`` against the reference's ``adamw`` update on the same
    inputs within ADAMW_FORMULA_SLACK of each entry; the slack's
    controls: the update's sign flipped (a negated learning rate), eps
    left out and the weight decay left out each fall outside it."""
    assert _adamw_formula_share() <= 1.0
    for wrong in ({"lr": topt.linear_warmup_cosine(-1e-2, warmup=1, total_steps=10)},
                  {"eps": 0.0}, {"weight_decay": 0.0}):
        assert _adamw_formula_share(**wrong) > 1.0, wrong


def test_in_place_step_refuses_what_it_cannot_own():
    cfg = get_config("xlstm_350m").reduced()
    batch = {k: torch.from_numpy(v) for k, v in build_batch(
        cfg, 2, 8, np.random.default_rng(0)).items()}
    params = tbb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    no_update_ = dataclasses.replace(topt.adamw(1e-3), update_=None)
    with pytest.raises(ValueError, match="update_"):
        tbb.make_train_step(cfg, no_update_)(params, no_update_.init(params), batch)
    step = tbb.make_train_step(cfg, topt.adamw(1e-3))
    params = tbb.init_params(torch.Generator().manual_seed(0),
                             cfg.replace(param_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="f32"):
        step(params, topt.adamw(1e-3).init(params), batch)


@pytest.mark.parametrize("name,microbatches", [("hymba_1p5b", 2), ("qwen2_vl_2b", 4),
                                               ("whisper_medium", 2)])
def test_train_sizing_terms(name, microbatches):
    """The count's terms for a reduced train entry (bf16, remat): one f32
    gradient tree (the parameters' bytes), two f32 moments and the step,
    the remat inputs (every layer's input in bf16 at a microbatch's
    rows; an encoder-decoder's encoder inputs and output at its frames
    too), LOGIT_F32_COPIES f32 copies of a microbatch's text logits and
    the head's bf16 weights, a layer's backward, the optimizer's two copies of the largest leaf,
    and ``held`` as the docstring adds them."""
    cfg = get_config(name).reduced().replace(compute_dtype="bfloat16", remat=True)
    shape = SP.ShapeSpec("train_small", "train", 1024 + 64, 8)
    t = dryrun.held_terms(cfg, shape, microbatches=microbatches)
    params = SP.params_specs(cfg)
    n = sum(x.numel() for x in tree_leaves(params))
    rows = shape.batch // microbatches
    text = shape.seq - (cfg.vision_tokens if cfg.frontend == "vision_stub" else 0)
    kept = tbb.n_scan_layers(cfg) * shape.seq + (
        (cfg.n_enc_layers + 1) * SP.ENC_FRAMES if cfg.is_encdec else 0)
    assert t["params"] == t["grads"] == 4 * n
    assert t["moments"] == 8 * n + 4
    assert t["remat"] == rows * kept * cfg.d_model * 2
    assert t["logits"] == (dryrun.LOGIT_F32_COPIES * rows * text * cfg.vocab_size * 4
                           + 2 * cfg.vocab_size * cfg.d_model)  # the bf16 head
    assert t["layer"] == dryrun.LAYER_BACKWARD_COPIES * dryrun.layer_activation_bytes(
        cfg, params, rows, shape.seq)
    assert t["optimizer"] == 8 * max(x.numel() for x in tree_leaves(params))
    assert t["held"] == (t["params"] + t["moments"] + t["grads"] + t["batch"]
                         + max(t["remat"] + max(t["logits"], t["layer"]),
                               t["optimizer"]))
    rec = dryrun.size_entry(cfg, shape, microbatches)
    assert rec["held_bytes"] == t["held"] and rec["card_share"] == t["held"] / 80e9


@pytest.mark.parametrize("name", ["hymba_1p5b", "xlstm_350m", "whisper_medium",
                                  "qwen2_vl_2b"])
def test_meta_trace_counts_what_the_cpu_saves(name):
    """A layer's activations as the meta device counts them (the kernels'
    Functions saving what they save on the card, computing nothing)
    equal, byte for byte, what autograd saves when the same layer runs
    on the CPU."""
    cfg = get_config(name).reduced().replace(compute_dtype="bfloat16", remat=True)
    rows, pos = 2, 40
    meta = dryrun.layer_activation_bytes(cfg, SP.params_specs(cfg), rows, pos)
    params = tbb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert meta == dryrun.layer_activation_bytes(cfg, params, rows, pos) > 0


@pytest.mark.parametrize("name", ["hymba_1p5b", "qwen2_vl_2b"])
def test_make_entry_trains_a_reduced_model_on_the_cpu(name):
    """``make_entry``'s train function on a reduced model (bf16, remat)
    with ``dryrun.materialize``'s arguments, specs and arguments alike
    leaf by leaf: one step in place (the same tensors back, the step
    advanced, the parameters moved), a finite loss."""
    shape = SP.SHAPES["train_4k"]
    cfg = SP.one_card_config(name, shape)
    cfg = cfg.reduced().replace(compute_dtype="bfloat16", remat=True)
    small = SP.ShapeSpec("train_small", "train", 40, 4)
    fn, specs = SP.make_entry(cfg, small, microbatches=2)
    args = dryrun.materialize(cfg, small, torch.device("cpu"))
    for spec, arg in zip(specs, args, strict=True):
        assert [(tuple(s.shape), s.dtype) for s in tree_leaves(spec)] == [
            (tuple(a.shape), a.dtype) for a in tree_leaves(arg)]
    params, state, batch = args
    before = [x.clone() for x in tree_leaves(params)]
    out_params, out_state, metrics = fn(*args)
    assert out_params is params and out_state is state and int(state["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
