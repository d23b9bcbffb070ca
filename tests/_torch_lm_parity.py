"""Shared CPU parity checks of the port's language models against the JAX
reference (``tests/test_torch_lm_*.py``).

``reference_run(name)`` builds a config of ``configs.ARCH_IDS`` at
``reduced()`` on both sides, the reference's init (carried across with
``params_from_numpy``), a prompt (tokens, and the family's patches or
frames) made with numpy, and the reference's forward, prefill and 4
greedy decode steps. The ``check_*`` functions hold the port against
that run. Tolerances are those of ``tests/test_torch_lm.py``: logits
and decode caches within atol = rtol = 1e-4 (f32 sums in another order:
the port's attention is the flash kernel's plain version, an exact
softmax, where the reference runs its einsum or chunked online
softmax); greedy tokens equal wherever the reference's top-2 logit
margin exceeds 2e-4. The port's own consistency checks use the
reference test's tolerances (``tests/test_arch_smoke.py``).
"""
import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro.configs import get_config as jget
from repro.models import backbone as jbb
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve_lm
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tbb
from repro_torch.models import recurrent as trec

ATOL = RTOL = 1e-4
MARGIN = 2e-4
PROMPT, MAX_LEN, STEPS = 12, 32, 4


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def trees_close(got_np, want, atol=ATOL):
    """Two trees of arrays, one structure (lists and tuples as they are),
    leaf by leaf within atol."""
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        close(a, b, atol=atol)


def prompt(cfg, seed=1, b=2, s=PROMPT, n_frames=16):
    """numpy inputs of the family: tokens, and patches or frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.normal(0, 1, (b, cfg.vision_tokens, cfg.frontend_dim)
                                    ).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 1, (b, n_frames, cfg.frontend_dim)
                                   ).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def reference_run(name: str, reduce: bool = True) -> dict:
    """The reference's weights on both sides, a prompt, and the
    reference's forward / prefill / STEPS greedy decode steps, at
    ``reduced()`` (or as published, where ``reduce`` is false)."""
    jc, tc = jget(name), get_config(name)
    if reduce:
        jc, tc = jc.reduced(), tc.reduced()
    jp = jbb.init_params(jax.random.PRNGKey(1), jc)
    batch = prompt(jc)
    jl, jaux = jbb.forward(jp, jc, to_jax(batch))
    plog, pcache, idx = jbb.prefill(jp, jc, to_jax(batch), max_len=MAX_LEN)
    step = jax.jit(jbb.make_serve_step(jc))
    nxt = jnp.argmax(plog[:, -1], -1)[:, None].astype(jnp.int32)
    cache, steps = pcache, []
    for i in range(STEPS):
        logits, cache = step(jp, nxt, cache, jnp.asarray(idx + i))
        steps.append((np.array(nxt), np.asarray(logits)))
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    return dict(jc=jc, tc=tc, jp=jp,
                tp=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                batch=batch, index=int(idx), forward=np.asarray(jl),
                aux=float(jaux),
                prefill=np.asarray(plog), cache=pcache, steps=steps,
                last=np.array(nxt))


def check_init_shapes(name: str) -> None:
    """The port's init: the reference's tree, leaf shapes and dtypes
    (traced with ``eval_shape``, never built), and its scales."""
    jc, tc = jget(name).reduced(), get_config(name).reduced()
    want = jax.eval_shape(lambda: jbb.init_params(jax.random.PRNGKey(0), jc))
    got = tbb.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    got_np = params_to_numpy(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(float(got["embed"]["table"].std()) / 0.02 - 1) < 0.05
    assert bool((got["final_norm"]["g"] == 1).all())


def check_forward(lm) -> None:
    got, aux = tbb.forward(lm["tp"], lm["tc"], to_torch(lm["batch"]))
    assert tuple(got.shape) == lm["forward"].shape
    close(got.numpy(), lm["forward"])
    if lm["tc"].n_experts:
        close(float(aux), lm["aux"])
    else:
        assert float(aux) == lm["aux"] == 0.0


def check_prefill(lm) -> None:
    logits, cache, index = tbb.prefill(lm["tp"], lm["tc"], to_torch(lm["batch"]),
                                       max_len=MAX_LEN)
    assert index == lm["index"] and tuple(logits.shape) == lm["prefill"].shape
    close(logits.numpy(), lm["prefill"])
    trees_close(params_to_numpy(cache), lm["cache"])


def check_greedy_decode(lm) -> None:
    """STEPS decode steps fed the reference's tokens: logits within
    tolerance; the port's greedy token is the reference's wherever the
    reference's top-2 margin exceeds MARGIN."""
    _, cache, idx = tbb.prefill(lm["tp"], lm["tc"], to_torch(lm["batch"]),
                                max_len=MAX_LEN)
    for i, (tok, want) in enumerate(lm["steps"]):
        logits, cache = tbb.decode_step(lm["tp"], lm["tc"], torch.from_numpy(tok),
                                        cache, idx + i)
        close(logits.numpy(), want)
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        assert np.array_equal(logits[:, -1].argmax(-1).numpy()[sure],
                              want[:, -1].argmax(-1)[sure])


def check_decode_from_reference_cache(lm) -> None:
    """The reference's prefill cache carried across decodes in the port
    as it does in the reference, and the cache comes back in its tree."""
    cache = params_from_numpy(jax.tree.map(np.asarray, lm["cache"]), "cpu")
    tok, want = lm["steps"][0]
    logits, new = tbb.decode_step(lm["tp"], lm["tc"], torch.from_numpy(tok),
                                  cache, lm["index"])
    close(logits.numpy(), want)
    assert (jax.tree.structure(params_to_numpy(new))
            == jax.tree.structure(jax.tree.map(np.asarray, lm["cache"])))


def check_prefill_matches_forward(lm, decode: bool) -> None:
    """The reference's own consistency checks, on the port: prefill's last
    logits equal forward's, and (``decode``) a step after prefill equals
    forward on the extended sequence."""
    p, cfg = lm["tp"], lm["tc"]
    batch = to_torch(lm["batch"])
    lg, cache, idx = tbb.prefill(p, cfg, batch, max_len=MAX_LEN)
    full, _ = tbb.forward(p, cfg, batch)
    close(lg[:, 0].numpy(), full[:, -1].numpy(), atol=2e-4, rtol=2e-4)
    if not decode:
        return
    nt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32))
    lg2, _ = tbb.decode_step(p, cfg, nt, cache, idx)
    full2, _ = tbb.forward(p, cfg, dict(batch, tokens=torch.cat(
        [batch["tokens"], nt], 1)))
    close(lg2[:, 0].numpy(), full2[:, -1].numpy(), atol=5e-4, rtol=5e-4)


def check_generate(lm) -> None:
    """serve_lm.generate against the reference's greedy tokens, up to the
    first step whose top-2 margin is within MARGIN."""
    batch = to_torch(lm["batch"])
    tokens = batch.pop("tokens")
    res = serve_lm.generate(lm["tp"], lm["tc"], tokens, gen=STEPS,
                            max_len=MAX_LEN, inputs=batch)
    want = np.concatenate([t for t, _ in lm["steps"]] + [lm["last"]], axis=1)
    margins = [np.diff(np.sort(lg[:, -1], -1)[:, -2:], axis=-1).min()
               for _, lg in lm["steps"]]
    sure = 1 + next((i for i, m in enumerate(margins) if m <= MARGIN), STEPS)
    assert res["tokens"].shape == (2, 1 + STEPS) and res["tokens"].dtype == torch.int32
    assert np.array_equal(res["tokens"].numpy()[:, :sure], want[:, :sure])
    assert len(res["decode_s"]) == STEPS and res["prefill_s"] > 0


# ------------------------------------------------ bf16 serving (item 16) --

def np32(tree):
    """A tree of tensors or arrays (bf16 included) -> the same tree of f32
    numpy arrays, dicts and tuples kept (``jax.tree.leaves`` then orders
    both packages' leaves alike)."""
    if isinstance(tree, dict):
        return {k: np32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np32(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree).astype(np.float32)


def bf16_run(name: str, **overrides) -> dict:
    """``reference_run`` at the production numerics of ``launch/specs.py``
    (bf16 compute, f32 parameters, a bf16 decode cache), reduced: the
    reference's prefill and STEPS greedy decode steps."""
    kw = dict(compute_dtype="bfloat16", **overrides)
    jc, tc = jget(name).reduced().replace(**kw), get_config(name).reduced().replace(**kw)
    jp = jbb.init_params(jax.random.PRNGKey(1), jc)
    batch = prompt(jc)
    plog, pcache, idx = jbb.prefill(jp, jc, to_jax(batch), max_len=MAX_LEN,
                                    cache_dtype=jnp.bfloat16)
    step = jax.jit(jbb.make_serve_step(jc))
    nxt = jnp.argmax(plog[:, -1], -1)[:, None].astype(jnp.int32)
    cache, steps = pcache, []
    for i in range(STEPS):
        logits, cache = step(jp, nxt, cache, jnp.asarray(idx + i))
        steps.append((np.array(nxt), np32(logits)))
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    return dict(jc=jc, tc=tc, tp=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                batch=batch, index=int(idx), prefill=np32(plog),
                prefill_cache=np32(pcache), cache=np32(cache),
                cache_dtypes=[str(x.dtype) for x in jax.tree.leaves(cache)],
                steps=steps)


def bf16_close(got, want, roundings: int) -> float:
    """``got`` within ``chip_smoke.bf16_share``'s bound of ``want`` after
    ``roundings`` bf16 roundings; returns the share of the bound."""
    share = chip_smoke.bf16_share(np32(got), np32(want), roundings)
    assert share <= 1.0, (share, roundings)
    return share


def bf16_caches_close(cfg, got, want) -> float:
    """Two decode caches of one structure, each stacked leaf's layer i
    within the bound of the blocks through i
    (``chip_smoke.bf16_cache_share``); returns the share."""
    got, want = np32(got), np32(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    share = chip_smoke.bf16_cache_share(cfg, jax.tree.leaves(got),
                                        jax.tree.leaves(want))
    assert share <= 1.0, share
    return share


def check_bf16_serving(lm) -> None:
    """The port's prefill (bf16 cache) and STEPS decode steps fed the
    reference's tokens, against the reference: logits and every cache
    leaf within ``chip_smoke.bf16_share``'s bound, in the reference's dtypes (bf16
    logits and K/V, f32 recurrent states)."""
    tc = lm["tc"]
    logits, cache, idx = tbb.prefill(lm["tp"], tc, to_torch(lm["batch"]),
                                     max_len=MAX_LEN, cache_dtype=torch.bfloat16)
    assert idx == lm["index"] and logits.dtype == torch.bfloat16
    bf16_close(logits, lm["prefill"], chip_smoke.bf16_roundings(tc))
    bf16_caches_close(tc, cache, lm["prefill_cache"])
    for i, (tok, want) in enumerate(lm["steps"]):
        logits, out = tbb.decode_step(lm["tp"], tc, torch.from_numpy(tok), cache,
                                      idx + i)
        assert out is cache and logits.dtype == torch.bfloat16
        bf16_close(logits, want, chip_smoke.bf16_roundings(tc))
    bf16_caches_close(tc, cache, lm["cache"])
    assert ([str(x.dtype).split(".")[-1] for x in jax.tree.leaves(cache)]
            == lm["cache_dtypes"])



# the kernel wrappers a model calls, by the kernel's name
KERNEL_CALLS = {"flash_attention": (tattn, "flash_attention"),
                "mlstm_scan": (trec, "mlstm_scan"),
                "slstm_cell": (trec, "slstm_cell")}


@contextlib.contextmanager
def zeroed_first_call(kernel: str):
    """Within the block, the first call of ``kernel``'s wrapper in the
    port's models returns zeros for its output (a wrong kernel, for the
    bound's control)."""
    mod, name = KERNEL_CALLS[kernel]
    orig, calls = getattr(mod, name), []

    def wrong(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(1)
        if len(calls) > 1:
            return out
        if isinstance(out, tuple):
            return (torch.zeros_like(out[0]),) + out[1:]
        return torch.zeros_like(out)

    setattr(mod, name, wrong)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


def bf16_control_share(lm, kernel: str) -> float:
    """The share of the bf16 bound that the port's prefill logits reach
    with the first call of ``kernel`` zeroed."""
    with zeroed_first_call(kernel) as calls:
        logits, _, _ = tbb.prefill(lm["tp"], lm["tc"], to_torch(lm["batch"]),
                                   max_len=MAX_LEN, cache_dtype=torch.bfloat16)
    assert calls, f"{kernel} not called"
    return chip_smoke.bf16_share(np32(logits), lm["prefill"],
                                 chip_smoke.bf16_roundings(lm["tc"]))
