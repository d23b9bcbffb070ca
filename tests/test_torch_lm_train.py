"""Language-model training in the PyTorch port against the JAX
reference, on the CPU: ``loss_fn`` and its gradients, ``make_train_step``
(AdamW with ``linear_warmup_cosine``, one and two microbatches), and the
optimizer and data helpers it uses.

Models: ``xlstm_350m.reduced()`` (one pair, d 128, vocab 512) and
``blendfl_paper`` (two pairs, d 256), the reference's init carried across
with ``params_from_numpy``; batches of 2 x 128 tokens drawn with numpy.
The port's gradients run the mLSTM-scan and sLSTM autograd functions'
CPU paths (the plain forwards and backwards).

Tolerances (``tests/_torch_lm_train_parity.py``; f32 sums in other
orders: the port's step recurrences against the reference's chunkwise
scan, over 128 steps):
- loss within rtol 1e-5;
- each gradient leaf within 1e-4 of that leaf's largest |gradient|
  (seen: 8e-6);
- after three AdamW steps the moments, sums of gradients, as the
  gradients (1e-4 of each leaf's largest |moment|); the parameters within a tenth of the summed learning rates,
  with at most 1e-3 of them more than 1e-6 away. AdamW divides by
  sqrt(v) + 1e-8, so an entry whose gradient lies within f32 noise of 0
  takes a step whose size that noise decides (up to lr_t): a few entries
  move apart by up to 3% of the summed rate (seen: 7.2e-5 of 2.5e-3, at
  about 140 of 477,000 entries; 119 of them biases of the sLSTM's 512),
  the rest agree within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jget
from repro.data.pipeline import token_batches as jtoken_batches
from repro.models import backbone as jbb
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import token_batches
from repro_torch.models import backbone as tbb

from _torch_lm_train_parity import (
    GRAD_REL,
    LOSS_RTOL,
    assert_leafwise,
    check_three_adamw_steps,
)
from _torch_lm_train_parity import leaves as _leaves
from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)


def _cfgs(name):
    jc, tc = jget(name), get_config(name)
    return (jc.reduced(), tc.reduced()) if name == "xlstm_350m" else (jc, tc)


def _model(name):
    jc, tc = _cfgs(name)
    jp = jbb.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batches(vocab, n, batch=2, seq=128, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, seq + 1))
        toks[:, 2::2] = toks[:, 1:-1:2]
        b = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
        if mask:
            b["loss_mask"] = (rng.random((batch, seq)) < 0.7).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("name,mask", [("xlstm_350m", False), ("xlstm_350m", True),
                                       ("blendfl_paper", False)])
def test_loss_and_gradients_match_jax(name, mask):
    jc, tc, jp, tp = _model(name)
    (batch,) = _batches(jc.vocab_size, 1, mask=mask)
    (jtotal, jm), jg = jax.value_and_grad(jbb.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    total, metrics, grads = tbb._value_and_grad(
        tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    for want, got in ((jtotal, total), (jm["loss"], metrics["loss"]),
                      (jm["aux"], metrics["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    # the public loss_fn is the same function, with a graph
    t2, _ = tbb.loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(t2) == float(total)
    assert_leafwise(jax.tree.map(np.asarray, jg), params_to_numpy(grads),
                    GRAD_REL, "gradient")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_adamw_steps_match_reference_train_step(microbatches):
    jc, tc, jp, tp = _model("xlstm_350m")
    check_three_adamw_steps(jc, tc, jp, tp, _batches(jc.vocab_size, 3, seed=1),
                            microbatches=microbatches)


def test_microbatch_metrics_follow_the_reference():
    """With microbatches the reference reports loss = the mean total and
    aux = 0; one microbatch reports its own loss and aux."""
    _, tc, _, tp = _model("xlstm_350m")
    (batch,) = _batches(tc.vocab_size, 1, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = topt.sgd(0.0)
    _, _, one = tbb.make_train_step(tc, opt)(tp, opt.init(tp), batch)
    _, _, two = tbb.make_train_step(tc, opt, microbatches=2)(tp, opt.init(tp), batch)
    halves = [tbb.loss_fn(tp, tc, {k: v[i:i + 1] for k, v in batch.items()})[0]
              for i in range(2)]
    assert float(two["loss"]) == float((halves[0] + halves[1]) / 2)
    assert float(two["aux"]) == 0.0 and float(two["total"]) == float(two["loss"])
    assert float(one["loss"]) == float(one["total"])


def test_schedule_matches_reference():
    jfn = jopt.linear_warmup_cosine(3e-4, warmup=10, total_steps=50)
    tfn = topt.linear_warmup_cosine(3e-4, warmup=10, total_steps=50)
    for step in range(0, 61):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_clip_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32), np.float32(0.3)]}
    jout, jnorm = jopt.global_norm_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    tout, tnorm = topt.global_norm_clip(
        {"a": torch.from_numpy(tree["a"]),
         "b": [torch.from_numpy(tree["b"][0]), torch.tensor(tree["b"][1])]},
        max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for (_, w), (_, g) in zip(_leaves({"a": jout["a"], "b0": jout["b"][0],
                                       "b1": jout["b"][1]}),
                              _leaves({"a": tout["a"].numpy(),
                                       "b0": tout["b"][0].numpy(),
                                       "b1": tout["b"][1].numpy()})):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_token_batches_match_reference():
    want = list(jtoken_batches(512, 3, 17, 4, seed=5))
    got = list(token_batches(512, 3, 17, 4, seed=5))
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
