"""bf16 serving of the PyTorch port against the JAX reference on the CPU,
at the production numerics ``launch/specs.py`` sets (bf16 compute, f32
parameters, a bf16 decode cache; the reference's ``dryrun_config``):
prefill and 4 decode steps fed the reference's greedy tokens for
phi4-mini-3.8b (dense), hymba-1.5b (its window and the Mamba heads) and
xlstm-350m, each at ``reduced()`` (whisper and deepseek at moe_groups =
2: ``tests/test_torch_lm_bf16_encdec_moe.py``).

Tolerance: ``chip_smoke.bf16_share``'s bound, derived, not fitted: each
bf16 rounding on a row's path may put two correct runs one bf16 ulp
apart an entry, at most 2^-7 of the row's norm; distinct roundings add
in quadrature, so after r of them (16 a block, 3 outside) a row agrees
within sqrt(r) 2^-7 of its norm. The logits are held to every block's
roundings, each cache leaf's layer i to those of the blocks through i.
The reference's attention and the port's kernel (its plain version
here) both compute in f32 and round once. The bound's control: with
one call of a kernel the family runs zeroed (one attention's output,
one scan's), the prefill logits fall outside it.

Also the decode step's in-place contract (``backbone.decode_step``): it
returns the cache it was given, writes the token's K/V into slot
``index % length`` of each ring and nothing else of it, replaces each
recurrent state, and gives bit for bit what a step on a clone gives,
in f32 and in bf16.
"""
import numpy as np
import pytest
import torch

import _torch_lm_parity as P
from _torch_parity import one_torch_thread  # noqa: F401  (a module fixture)
from repro_torch.common.tree import tree_leaves
from repro_torch.models import backbone as tbb

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("phi4_mini_3p8b", "hymba_1p5b", "xlstm_350m")


@pytest.fixture(scope="module", params=NAMES)
def lm(request):
    return P.bf16_run(request.param)


def test_bf16_prefill_and_decode_match_jax(lm):
    P.check_bf16_serving(lm)


@pytest.mark.parametrize("lm,kernel", [
    ("phi4_mini_3p8b", "flash_attention"), ("hymba_1p5b", "flash_attention"),
    ("hymba_1p5b", "mlstm_scan"), ("xlstm_350m", "mlstm_scan"),
    ("xlstm_350m", "slstm_cell")], indirect=["lm"])
def test_bf16_bound_rejects_one_zeroed_kernel_call(lm, kernel):
    assert P.bf16_control_share(lm, kernel) > 1.0


@pytest.mark.parametrize("name", ["hymba_1p5b", "xlstm_350m", "whisper_medium",
                                  "deepseek_moe_16b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_writes_into_the_cache_it_is_given(name, dtype):
    cfg = P.get_config(name).reduced().replace(compute_dtype=dtype)
    params = tbb.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    batch = P.to_torch(P.prompt(cfg, seed=4))
    _, cache, idx = tbb.prefill(params, cfg, batch, max_len=P.MAX_LEN)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32))
    before = tbb.clone_cache(cache)
    twin = tbb.clone_cache(cache)
    ptrs = [x.data_ptr() for x in tree_leaves(cache)]
    logits, out = tbb.decode_step(params, cfg, tok, cache, idx)
    assert out is cache and [x.data_ptr() for x in tree_leaves(out)] == ptrs
    want, twin_out = tbb.decode_step(params, cfg, tok, twin, idx)
    assert torch.equal(logits, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                 tree_leaves(twin_out)))
    for path, now in _leaves_by_path(out).items():
        was = _leaves_by_path(before)[path]
        if path[-1] in ("k", "v"):  # a ring: slot idx % length only
            length = now.shape[2]
            slot = idx % length
            others = [i for i in range(length) if i != slot]
            assert torch.equal(now[:, :, others], was[:, :, others])
            assert not torch.equal(now[:, :, slot], was[:, :, slot])
        elif path[0] == "cross":
            assert torch.equal(now, was)
        else:  # a recurrent state, replaced by the next
            assert not torch.equal(now, was)


def _leaves_by_path(tree, path=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _leaves_by_path(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _leaves_by_path(v, path + (i,)).items()}
    return {path: tree}
