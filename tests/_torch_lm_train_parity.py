"""Shared CPU parity checks of the port's language-model training against
the JAX reference (``tests/test_torch_lm_train.py`` for the xLSTM
models, ``tests/test_torch_lm_train_{dense,hybrid,moe,encdec_vlm}.py``
for the attention families).

``narrow(name)`` cuts a published config to a few layers and narrow
widths with ``cfg.replace(...)``, keeping what the attention backward
has to carry: the family's group G = Hq / Hkv (``.reduced()`` turns
phi4, hymba and starcoder2 into G = 1), its window (cut to 16 so that
it binds at 48 tokens), its MoE and its frontend. Both packages build
the same config; the reference's init goes across with
``params_from_numpy``; batches come from the reference CLI's
``build_batch`` on a numpy stream (tokens, and the VLM's patches or the
encoder-decoder's 64 frames).

Tolerances (f32 sums in another order: the port's attention is the
plain flash forward and backward, its scans the plain step recurrences,
against the reference's einsum softmax and chunkwise scans under
``jax.grad``):
- loss within rtol 1e-5;
- each gradient leaf within 1e-4 of that leaf's largest |gradient|;
- after three AdamW steps the moments within 1e-4 of each leaf's
  largest, the parameters within a tenth of the summed learning rates,
  with at most 1e-3 of them more than 1e-6 away (AdamW's sqrt(v) + 1e-8
  turns the f32 noise of a gradient near 0 into a step of up to lr_t:
  ``tests/test_torch_lm_train.py`` has the readings).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import optim as jopt
from repro.configs import get_config as jget
from repro.launch.train import build_batch
from repro.models import backbone as jbb
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import backbone as tbb

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_RATE_SHARE, PARAM_CLOSE, PARAM_FAR_SHARE = 0.1, 1e-6, 1e-3
LR, WARMUP, TOTAL = 1e-3, 2, 3  # lr_t = 5e-4, 1e-3, 1e-3
BATCH, SEQ = 2, 48

# Per family: the heads (Hq, Hkv) and head dim that keep its group G,
# and what else it needs at these widths.
NARROW = {
    "phi4_mini_3p8b": dict(n_heads=6, n_kv_heads=2, head_dim=16),        # G 3
    "hymba_1p5b": dict(n_heads=5, n_kv_heads=1, head_dim=16, window=16),  # G 5
    "qwen2_vl_2b": dict(n_heads=6, n_kv_heads=1, head_dim=16,            # G 6
                        mrope_sections=(2, 3, 3)),
    "starcoder2_7b": dict(n_heads=9, n_kv_heads=1, head_dim=16),         # G 9
    "nemotron_4_15b": dict(n_heads=6, n_kv_heads=1, head_dim=16),        # G 6
    "dbrx_132b": dict(n_heads=6, n_kv_heads=1, head_dim=16),             # G 6
    "stablelm_3b": dict(n_heads=2, n_kv_heads=2, head_dim=80),           # d 80
    "deepseek_moe_16b": dict(n_heads=4, n_kv_heads=4, head_dim=16),
    "whisper_medium": dict(n_heads=4, n_kv_heads=4, head_dim=16),
}


def narrow(name: str, **extra):
    """(reference config, port config): ``reduced()`` (2 layers, d_model
    <= 128, vocab <= 512, <= 4 experts, f32) with NARROW's heads on
    d_model 64."""
    kw = dict(NARROW[name], d_model=64, **extra)
    return jget(name).reduced().replace(**kw), get_config(name).reduced().replace(**kw)


def model(name: str, seed: int = 0, **extra):
    jc, tc = narrow(name, **extra)
    jp = jbb.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def batches(cfg, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [build_batch(cfg, BATCH, SEQ, rng) for _ in range(n)]


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{path}/{i}")]
    return [(path, np.asarray(tree))]


def assert_leafwise(want, got, rel, what):
    pairs = list(zip(leaves(want), leaves(got)))
    assert len(pairs) == len(leaves(want)) == len(leaves(got))
    for (path, w), (gpath, g) in pairs:
        assert path == gpath and w.shape == g.shape, (path, gpath)
        tol = rel * np.abs(w).max() + 1e-12
        err = np.abs(g - w).max()
        assert err <= tol, f"{what} {path}: {err} > {tol}"


def check_loss_and_gradients(name: str, **extra) -> None:
    """``loss_fn`` (total, loss, aux) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; the public
    ``loss_fn`` gives the same total."""
    jc, tc, jp, tp = model(name, **extra)
    (batch,) = batches(jc, 1)
    (jtotal, jm), jg = jax.value_and_grad(jbb.loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics, grads = tbb._value_and_grad(tp, tc, tb)
    for want, got in ((jtotal, total), (jm["loss"], metrics["loss"]),
                      (jm["aux"], metrics["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    t2, _ = tbb.loss_fn(tp, tc, tb)
    assert float(t2) == float(total)
    assert_leafwise(jax.tree.map(np.asarray, jg), params_to_numpy(grads),
                    GRAD_REL, "gradient")


def lr_at(step):
    return topt.linear_warmup_cosine(LR, warmup=WARMUP, total_steps=TOTAL)(
        torch.tensor(step, dtype=torch.int32))


def check_three_adamw_steps(jc, tc, jp, tp, steps, microbatches: int = 1) -> None:
    """``make_train_step`` (AdamW, ``linear_warmup_cosine``) over the
    three numpy batches ``steps`` against the reference's jitted
    ``make_train_step`` from the same parameters (``jp``, and ``tp`` its
    copy): the metrics each step, then the moments and the parameters."""
    jo = jopt.adamw(jopt.linear_warmup_cosine(LR, warmup=WARMUP, total_steps=TOTAL))
    to = topt.adamw(topt.linear_warmup_cosine(LR, warmup=WARMUP, total_steps=TOTAL))
    jstep = jax.jit(jbb.make_train_step(jc, jo, microbatches=microbatches))
    tstep = tbb.make_train_step(tc, to, microbatches=microbatches)
    js, ts = jo.init(jp), to.init(tp)
    lr_sum = 0.0
    for i, batch in enumerate(steps):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(tm) == sorted(jm) == ["aux", "loss", "total"]
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
        lr_sum += float(lr_at(i + 1))
    assert int(ts["step"]) == int(js["step"]) == 3
    for key in ("mu", "nu"):
        assert_leafwise(jax.tree.map(np.asarray, js[key]), params_to_numpy(ts[key]),
                        GRAD_REL, key)
    far, total = 0, 0
    for (path, w), (_, g) in zip(leaves(jax.tree.map(np.asarray, jp)),
                                 leaves(params_to_numpy(tp))):
        err = np.abs(g - w)
        assert err.max() <= PARAM_RATE_SHARE * lr_sum, (path, err.max(), lr_sum)
        far += int((err > PARAM_CLOSE).sum())
        total += err.size
    assert far <= PARAM_FAR_SHARE * total, (far, total)
