#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phase4-repeats N]

Runs from the repository root (it imports ``src/repro_torch``) and needs
one CUDA card; it exits non-zero, printing no result, without one or
outside a checkout. Phases, each fatal on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout, one
   nvcc per source, all at once, started before the imports and phase 1,
   which it overlaps;
3. wire codec against plain: the fused op (each row's scale and top-k
   threshold selected on the card, then the pass) and the pass alone
   given the library top-k's [scale, thresh], on tensors on the card,
   held against the plain PyTorch version bit for bit (serving shapes,
   ragged N, an all-zero row, ties at the threshold, bf16, every codec,
   the features the full-width encoders produce, and the message shapes
   of a full and of a K = 4 sampled training round, which take the
   multi-CTA select), then timed with CUDA events beside the top-k
   composition (library top-k, then the pass), the pass alone, the plain
   version and the HBM bound, the kernels each call puts on the card
   held to the launcher's count, and at its least work, one row of 32
   entries (the launch floor);
4. full-width serving: the ``ServingEngine`` (int8_topk codec) over three
   request mixes on the widest BlendFL model the repository supports
   (MLP encoders, d_hidden=1024, 4 layers, 64x128 features per modality,
   25 labels), with weights from a seed; scores checked for range, route,
   agreement with single-request ``predict`` and with the CPU run of the
   same models, and the wire bytes against the analytic cost; kernel
   launch counts read around this run (3 wire-codec launches a VFL
   micro-batch, none of any other kernel); the host CPU's model and the
   CPU references' thread count (pinned to CPU_THREADS before the first
   CPU product), and with ``--phase4-repeats N`` the whole phase N times,
   each run's card-vs-CPU reading printed;
5. the CLI: ``repro_torch.launch.serve_federated --selftest`` serving a
   federation it trains inline on the card (2 rounds, 3 clients);
6. blend kernel against plain: the BlendAvg blend on the card against its
   plain version at the test shapes, the training round's leaf shapes
   and a K = 4 sampled round's ((4, 1,048,576), (5, 2,097,152),
   (4, 2,097,152), (5, 262,144)), a zero omega and bf16, then timed
   beside the plain version, the library call ``omega @ stacked`` and
   the HBM bound; then one full-width round's three group trees (A and B
   at 16 rows, M at 17) blended in one launch each, held bit for bit
   against one-leaf launches, timed beside the 30 one-leaf launches, the
   30 per-leaf ``omega @ stacked`` and the bound, and the host time of
   entering ``torch.cuda.device``;
7. full-width training: BlendFL rounds (Algorithm 1 with BlendAvg, SGD)
   of 16 clients on the same model width, 8192 training rows: phase
   seconds, finite losses, omegas, blend launches of exactly one per
   group that blended (A, B, M), one round's blend held against the
   plain version, ``evaluate_global``, a profiled round, then one round
   under the ``int8_topk`` wire codec (one codec launch per leaf each
   way) and the codec's times at the round's message shapes;
8. card against CPU: the quickstart-shaped federation, 2 rounds from the
   same weights and shuffles on both, then one ``int8_topk`` codec round,
   3 async rounds of 2 sampled clients under the ``staleness`` policy
   (the same ids on both), 2 rounds of scaffold with the adam server
   optimizer, and 2 median rounds at 4 clients, within the CPU parity
   tests' tolerances (the codec round's params at the lossy run-level
   tolerance);
9. sLSTM cell against plain: the built kernel's partition of each call
   (clusters, rows and units a CTA, shared memory) against
   ``slstm_cell.plan`` with the card's cluster budget, in one wave; the kernel
   on the card against its plain version at the CPU tests' shapes, the
   partition's edges (a ragged last row group, H = 1, a ragged last CTA
   of units) and the recurrent encoder's full width (B = 2 and 64 rows,
   4 heads, S = 64, hd = 256), f32 and bf16, then timed at the serving
   capacities beside the plain version and the bound;
10. flash attention against plain: every mask and shape of the CPU tests
   (causal, GQA, MQA with Sq < Sk, ragged, windows 8/32/127,
   non-causal), the edges of the kernel's tiling (Sq not a multiple of
   its 64-row blocks, Sk not a multiple of its 32-key tiles, d = 10 and
   256 with 4 query heads a K/V head, windows across tiles), causal Sq >
   Sk, whose rows without a visible key must be exactly 0, the
   transformer encoder's full width (64, 4, 64, 256) and a long causal
   GQA case (1, 8, 2, 1024, 1024, 128), f32 and bf16; then timed at full
   width (f32, bf16) and the long case (f32, bf16), each beside
   ``scaled_dot_product_attention`` on the same inputs (timed only, never
   on the path), with the plain version at full width f32, the bound and
   the kernel/SDPA ratio;
11. full-width serving with the recurrent, then the transformer encoders
   (d_hidden=1024, 4 heads of 256; phase 4's set-up and checks on
   VARIANT_REQUESTS requests a mix, 16 for the recurrent encoder, whose
   CPU reference is the costliest, 64 for the transformer): each encoder
   kernel launches exactly once per encoder application (2 per
   multimodal or VFL micro-batch, 1 per unimodal one), a profiled mix;
   for the recurrent encoder, its card-vs-CPU difference layer by layer
   on the fixed streams' VFL rows (input layer, the sLSTM's input
   projection, its h sequence, the feature, the kernel alone);
12. the CLI: ``serve_federated --selftest --train-rounds 0`` with each of
   the two encoders, then ``--train-rounds 2`` (trained inline through the
   backward kernels), on the card;
13. mLSTM scan against plain: the kernel's plan at full width (cluster
   size from the card's cluster capacities, waves, shared memory) and
   its ptxas registers and spills; the kernel's h and final (C, n)
   against its plain version (the step recurrence) at the CPU tests'
   shapes, a ragged S, and xlstm-350m's (8, 4, 512, 512, 512) at chunk
   64, normalize on and off, then timed beside the plain version and the
   bound at both rates (f32 on SIMT, 3xTF32 on the tensor cores);
14. the sLSTM cell from a running state against plain: prefill length
   (8, 4, 512, 256), a decode step (S = 1), hd = 100 and a decode step
   at 10 rows, output and final state, then the first two timed;
15. full-width xlstm-350m serving through ``repro_torch.launch.serve_lm``
   (24 layers, d_model 1024, random weights from seed 0; ``lm_family``,
   as phases 23 and 25): prefill of 8 x 512 tokens and 32 greedy decode
   steps, exactly 12 mLSTM + 12 sLSTM launches in prefill and 0 + 12 in
   each decode step and no other kernel, prefill against ``forward``, a
   decode step against forward on the extended sequence, a profiled
   prefill and step;
16. xlstm-350m card against CPU: prefill of 2 x 128 tokens and 4 decode
   steps fed the CPU's greedy tokens, logits and caches within
   LM_CPU_TOL;
17. full-width sampled and strategy rounds: phase 7's federation at K = 4
   of its 16 clients: 3 async BlendAvg rounds (uniform policy; wall time
   beside phase 7's full round, ids, staleness, ``last_round`` moving
   only at the participants, finite losses, one blend launch a group
   that blended) and a profiled one, a round under each other
   policy, a round of each strategy and server optimizer (fedavg,
   fedprox, scaffold, fedavg with adam and with momentum, median and
   trimmed_mean launching no blend, krum one a group) with its peak
   device memory, and a sampled async ``int8_topk`` round (one codec
   launch a leaf each way);
18. full-width sharded rounds: ``federation_sharded.make_blendfl_round``
   at the reference's widest BlendFL entry (16 clients, d_hidden 1024, 4
   layers, 512 rows a client and phase, a 2048-row validation set scored
   on 512, AdamW) fed by ``FederatedBatcher`` over phase 7's partition:
   3 full rounds through the prefetching stream (round wall, the wait
   for the batch, the batcher's build and stall seconds, peak memory)
   and a profiled one, 3 K = 4 async rounds under ``omega_ema`` (ids and
   ``last_round`` moving only at the participants) and a K = 4
   ``int8_topk`` round; finite losses, one blend launch a group every
   round, one codec launch a leaf each way, no other kernel;
19. the training CLI on the card, in a child process that sets
   ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts: ``--selftest-resume``
   on the Makefile's eight resume lanes under deterministic algorithms
   (bit for bit, the same launches every round of every leg), a
   full-width checkpointed run of 2 rounds resumed to 3 by a second
   invocation (4 and 6 before the run neared its time limit), ``import``
   and a store-backed run, and
   ``serve_federated --selftest`` on the checkpoint the port wrote;
20. sharded rounds card against CPU: the Makefile's sampled
   ``omega_ema`` and ``int8_topk`` lanes, 3 rounds on both from the same
   state, within phase 8's tolerances (the SGD codec lane's params at
   the lossy run-level tolerance; the CLI's AdamW codec lane, whose
   top-k picks tie, on what a tie cannot move and each uplink message
   through the codec kernel against its plain version), the CPU run's
   BlendAvg deltas 1e-3 from a tie;
21. full-width baselines: the paper's eight (``core/baselines.py``:
   FedAvg, FedProx, FedNova, FedMA, HFCL, SplitNN, One-Shot VFL,
   centralized) once each on phase 7's data and model (1 round of 1
   local epoch): wall seconds, blend launches equal to the analytic count
   (one launch a model tree blended: 5 a round for the HFL five, 4 for
   One-Shot VFL, none for SplitNN and centralized), peak memory, the six metrics each NaN or in [0, 1];
   SplitNN timed again and profiled (busy, idle share, the kernels that
   take most); FedAvg's blends against the plain version, FedMA's matching seconds
   and one (1024, 1024) matching against a numpy copy of the reference's
   loop, and a matched member with its hidden units shuffled through
   ``_match_encoder`` on the card against the loop's permutation; then FedAvg,
   FedNova, SplitNN and One-Shot VFL at phase 8's width, card against CPU
   from the same weights (params at phase 8's tolerance, metrics within
   EVAL_ATOL); then the seven that train the recurrent and transformer
   encoders (all but FedMA, which refuses them) once each at full width
   (4 heads of 256) on 4 of the 16 clients: blend launches against the
   analytic count, the
   encoder's forward and backward kernels launched, no other kernel, the
   six metrics;
22. training the recurrent and transformer encoders: each backward
   kernel (sLSTM BPTT, flash attention's dq / dk, dv) against its plain
   backward on the same saved inputs at full width, on one client's slice
   (64 rows, 4 heads of 256, S = 64) and at a round's 16 stacked clients
   (1024 rows), within ``slstm_grad_error_bound`` /
   ``flash_grad_error_bound``, then timed at 1024 rows beside the plain
   backward and the bound; one full-width BlendAvg round on each encoder
   (phase 7's 16 clients and data, d_hidden 1024, 4 heads of 256): wall,
   peak memory, finite losses, launches (one forward launch a stacked
   application in training, one an application in scoring; one sLSTM
   backward or two flash backward launches a stacked application; phase
   7's blends; no other kernel), a profiled round, ``evaluate_global``;
   then 2 rounds card against CPU on each at phase 8's width and
   tolerances (4 heads of 12, data seed 2), the CPU run's BlendAvg
   deltas 1e-3 from a tie;
23. full-width phi4-mini-3.8b serving through ``serve_lm`` (32 layers,
   d_model 3072, vocab 200064, 4,450,424,832 f32 parameters, random
   from seed 0): init's peak memory, prefill of 8 x 512 tokens and 32
   greedy decode steps, exactly 32 flash launches a prefill and 32 a
   step and no other kernel, prefill against ``forward``, a decode step
   against forward on the extended sequence, a profiled prefill and
   step;
24. phi4-mini-3.8b card against CPU: 2 of its layers at full width from
   the same weights, prefill of 2 x 64 tokens and 4 decode steps fed the
   CPU's greedy tokens, logits and caches within LM_CPU_TOL;
25. the other families at full width (FAMILY_RUNS: qwen2-vl-2b with a
   vision prefix of 1024 patches, hymba-1.5b past its 1024-key ring,
   whisper-medium on 1500 frames, deepseek-moe-16b at 4 layers,
   starcoder2-7b, nemotron-4-15b, stablelm-3b and dbrx-132b at 2), each
   with its launches a stage asserted (flash; the mLSTM scan for hymba's
   Mamba heads), prefill against ``forward`` (hymba and whisper also a
   decode step against forward), the tokens the MoE layers drop at
   capacity, then card against CPU at a cut depth (MoE: the routers'
   choices equal, the top-k gap at least MOE_GAP; not nemotron-4-15b
   and dbrx-132b: their full-width CPU copies cost 19 s, and phase 33
   holds each family's bf16 card against CPU);
26. mLSTM backward against plain: the backward kernel's dq, dk, dv and
   dlog_f against the plain step-by-step backward within
   ``mlstm_grad_error_bound`` (ragged chunks, column blocks, normalize on
   and off, xlstm-350m's training shape (8, 4, 128, 512, 512) and hymba's
   Mamba heads (2, 25, 2048, 16, 64) without the normalizer), then timed
   at those two beside the plain backward, an autograd of the plain scan
   and the bound;
27. full-width xlstm-350m training through ``launch/train.py`` (the
   first XLSTM_TRAIN_LAYERS = 8 of its 24 layers by ``--layers``, batch
   8 x 128, ``train_run``): 20 AdamW steps with one checkpoint, at step
   12, the run resumed from it by a second invocation, finite losses, the resumed losses within
   LOSS_RTOL of the uninterrupted run's, exactly 4 launches a step of
   each of the mLSTM scan, its backward, the sLSTM cell and its
   backward; ms a step, peak memory, a profiled step;
28. xlstm-350m training card against CPU: 1 of its 12 layer pairs at
   full width (2 before phases 29-32 came), the loss and every gradient of a 2 x 128 batch, then 3
   AdamW steps (losses, moments, parameters; tolerances at
   TRAIN_GRAD_REL);
29. flash backward against plain at the attention families' training
   shapes (FLASH_BWD_LM_CASES: grouped K/V heads at G 3, 5, 6, 9,
   hymba's window of 1024 at 2 x 2048 tokens, qwen2-vl's 1152 positions,
   stablelm's d = 80, whisper's cross attention, a logit cap of 50):
   the forward's lse against plain, dq, dk, dv within
   ``flash_grad_error_bound``, two calls bit for bit, then timed beside
   the plain backward, the bound and SDPA's memory-efficient backward;
30. full-width hymba-1.5b training through ``launch/train.py`` (d 1600,
   the first HYMBA_LAYERS = 4 of its 32 layers by ``--layers``, 2 x 2048
   tokens, ``train_run``): 12 AdamW steps with one checkpoint, at step 8 (the free disk printed first),
   resumed from it, finite losses, the resumed losses within LOSS_RTOL,
   exactly ``train_launches`` a step (flash 4, its backward 8 kernels,
   the mLSTM scan 4, its backward 4 calls); ms a step, tokens/s, peak
   memory, a profiled step;
31. the other attention families' training at full width
   (FAMILY_TRAIN_RUNS: qwen2-vl-2b and whisper-medium whole,
   phi4-mini-3.8b at 8 layers on 8 x 128 tokens, stablelm-3b at 4,
   starcoder2-7b and deepseek-moe-16b at 2): 3 AdamW steps each, finite
   losses, ``train_launches`` a step, ms a step, peak memory;
32. every attention family's training card against CPU
   (CARD_CPU_TRAIN: narrow widths keeping each family's group G, hymba's
   window binding, 2 layers, 2 x 128 tokens): the loss and every
   gradient, then 3 AdamW steps, at phase 28's tolerances, MoE routers'
   choices equal;
33. the reference's production variants through ``launch/specs.py``
   (bf16 compute, f32 parameters, a bf16 cache; each entry's one-card
   share, one data shard's rows): the flash kernel in bf16 at the
   entries' shapes (FLASH_PRODUCTION_CASES: every family's 32k causal
   prefill, the 32768-key decode reading the cache in place, the rings
   of 4096 and 1024, hymba's window, stablelm's d = 80, whisper's cross
   attention) against its plain version within ``fref.bf16_error_bound``
   on the first, middle and last rows, a control (V with a quarter of
   its keys negated must fail the bound), and timed beside SDPA and the
   bound; the mLSTM scan (xlstm's and hymba's) and the sLSTM cell at
   their 32768-step prefill shapes against their plain recurrences on a
   window at each end (RECURRENT_WINDOW); the
   meta-device sizing of all 40 (arch, shape) entries and of the
   federated round (``launch/dryrun.py``), and ``dryrun --run`` on one
   entry; then each family of PRODUCTION_RUNS (phi4-mini-3.8b,
   hymba-1.5b, xlstm-350m, qwen2-vl-2b and whisper-medium whole, the
   others at phase 25's depth) at prefill_32k, decode_32k and long_500k
   (whisper skips it, as the reference does), timed by ``dryrun.
   time_entry``: ms, tokens/s, peak memory and the roofline's bound and
   share, launches asserted (one flash launch an attention), finite bf16
   logits, a decode step against the same step with every kernel's
   plain version (each kernel call held to its own bound on the input
   the step gives it, the logits to ``bf16_share``'s bound); phi4's
   decode cache from its own prefill of 2 rows, tiled to 8; then bf16
   card against CPU at 2
   layers (deepseek at 4 groups) within ``bf16_share``'s bound; each
   entry's peak memory held against ``dryrun.held_terms``' count (at
   most PEAK_OVER_COUNT times it, the count at most COUNT_OVER_PEAK times
   the peak); alone, after the build: ``c.production_phase(torch,
   counted, (flaunch, fref, mlaunch, mref, slaunch, sref), mem_rate)``
   with phase 4's ``counted``;
34. the production variant's training through ``launch/specs.py``
   (bf16 compute, f32 parameters, ``remat``, the in-place AdamW step;
   train_4k's one-card share, 16 x 4096 in ``default_microbatches``):
   the train_4k sizing of every family; the flash backward at hymba's
   and qwen2-vl's train_4k attentions on bf16 inputs cast up
   (FLASH_BWD_4K_CASES: the bf16 forward with its lse bit for bit the
   one without, its lse and output against plain, the backward against
   plain on the first and last (batch row, K/V group), the bf16
   autograd path the kernels' gradients cast down), timed beside SDPA's
   bf16 backward and the bound; the mLSTM backward at xlstm's and
   hymba's train_4k scans (MLSTM_BWD_4K_CASES) and the sLSTM BPTT at
   xlstm's (SLSTM_BWD_4K), each against its plain backward on the first
   and last (batch row, head) in full, then timed; card against CPU
   at 2 narrow layers in bf16 (hymba, xlstm: the loss and every
   gradient within ``bf16_share``'s bound) and remat against none on
   the card; then TRAIN_4K_RUNS
   (hymba-1.5b and xlstm-350m whole, qwen2-vl-2b, stablelm-3b and
   whisper-medium at 2 layers, phi4-mini-3.8b only if the count fits):
   ms a step, tokens/s, finite losses, ``train_launches`` a microbatch
   (forwards twice) times the microbatches, the peak against the count,
   busy / idle of a profiled step, the roofline's shares; alone, after
   the build: ``c.production_training(torch, counted, (flaunch, fbwd,
   fref, mlaunch, mbwd), mem_rate)``.

Phases 10 and 13 also hold the kernels against their plain versions at
the language models' shapes (FLASH_LM_CASES, a logit cap; MLSTM_HYMBA)
and time them, flash beside SDPA.

Phase 4's streams are fixed (``MIX_SALT`` stands in for the per-process
``hash(mix)``), so every run serves the same requests; its check accepts
a large error on the lossy VFL route only in a row whose recorded wire
messages differ between the two runs compared.

Every phase prints its time. It then prints one JSON line of per-kernel
numbers, the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Times: ``ms``, ``plain_ms`` and ``library_ms`` are per call, from CUDA
events around many calls; ``device_ms`` and its kin are the profiler's,
counted per kernel name (``per_call_device_ms``), and None, with a
``profiler dropped events`` line, where the profile lost launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Wire codec kernel vs plain version: identical keep-masks and int8
# codes, values within 4 * eps_f32 * scale_row, the dense identity exact.
# Blend kernel vs plain version: within
# repro_torch.kernels.blendavg.ref.blend_error_bound (the two sum their
# L products in different orders). Engine vs predict and card vs CPU
# serving use the serving tolerance of repro_torch.launch.serve_federated
# (within_tolerance).
EPS32 = float(np.finfo(np.float32).eps)

# The card's peak rates and memory rate (H100 SXM data sheet):
# repro_torch.launch.roofline, the port's one-card hardware model. Outside
# a checkout the import fails and main() says so.
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.launch.roofline import (  # noqa: E402
        BF16_OPS_PER_S,
        FP32_OPS_PER_S,
        TF32_OPS_PER_S,
        hbm_bytes_per_s,
    )
except ImportError:
    BF16_OPS_PER_S = FP32_OPS_PER_S = TF32_OPS_PER_S = hbm_bytes_per_s = None
CODEC_OPS_PER_ELEM = 8  # abs, compare, mul, rint, max, min, mul, select
BLEND_OPS_PER_ELEM = 2  # multiply, add

# Card vs CPU training: the tolerances of tests/test_torch_federation.py.
# The VFL gather's backward is an index-add, which CUDA runs with atomics
# in varying order; the run stays within these. Under the lossy int8_topk
# codec a last-ulp difference can flip a rare top-k or rounding decision:
# its params are held to all within LOSSY_MAX_ABS and at least
# LOSSY_SHARE of them within PARAM_ATOL.
LOSS_RTOL = 1e-4
OMEGA_ATOL = 1e-3
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
EVAL_ATOL = 1e-3
LOSSY_MAX_ABS, LOSSY_SHARE = 2e-2, 0.99

# Threads of the CPU references (torch.set_num_threads), pinned before
# the first CPU product: the chip machine's core count. A CPU GEMM's sum
# order may depend on its thread count (ROADMAP fault (n)).
CPU_THREADS = 8

# Timed kernels read inputs rotated over at least this many bytes, so
# that a launch finds its input in HBM, not in the 50 MB L2, as a
# round's blend does.
ROTATE_BYTES = 200e6


_phase = {"name": None, "t0": 0.0}


def phase(name):
    """Start phase ``name`` (None: end the last one), printing how long
    the previous phase took."""
    if _phase["name"] is not None:
        print(f"-- phase {_phase['name']!r} took "
              f"{time.perf_counter() - _phase['t0']:.1f} s", flush=True)
    _phase.update(name=name, t0=time.perf_counter())
    if name is not None:
        print(f"\n== {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, iters=200, warmup=10):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The warm-up kernel of every profile (ATen's ``spin_kernel``, launched by
# ``torch.cuda._sleep``), whose events ``device_kernels`` drops.
WARMUP_KERNEL = "spin_kernel"


def device_kernels(run) -> list:
    """Profile one call of ``run``: [(device us, calls, name)] of every
    kernel and copy it put on the card, largest first. Once this script
    has run its first phases, a profile can lose the first launch or two
    it sees (a profile of one flash launch recorded none, one of 50
    recorded 49), so each profile starts with a warm-up step of small
    kernels whose events the profiler's schedule should discard. It does
    not always: a profile of ten codec calls once held 15 of the 16
    warm-up launches. So the warm-up launches a kernel that nothing else
    in the port or this script launches (``torch.cuda._sleep``'s
    ``spin_kernel``), and its events are dropped by name; a few more of
    them open the recorded step, so that the launches it may lose first
    are theirs (a one-call profile of either training backward recorded
    none without them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(16):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends: record from here
        for _ in range(4):
            torch.cuda._sleep(1000)
        run()
        torch.cuda.synchronize()
        prof.step()
    return sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total > 0 and WARMUP_KERNEL not in ev.key),
                  reverse=True)


def per_call_device_ms(one_call, many, iters):
    """Device ms per call from two profiles of one function: ``one_call``
    (one call) and ``many`` (``iters`` calls), each [(device us, count,
    name)] as ``device_kernels`` gives them. Each name's time is divided
    by that name's own recorded count, and a call's time is the sum over
    names of time a launch times launches a call. Returns (ms or None,
    {name: (launches recorded in ``many``, ``iters`` times those in
    ``one_call``)} for the names where the two differ): a profile that
    dropped (or gained) events gives None, never a low number; so does
    one with no device time."""
    per_call = {name: n for _, n, name in one_call}
    recorded = {name: (us, n) for us, n, name in many}
    dropped = {name: (recorded.get(name, (0.0, 0))[1], iters * per_call.get(name, 0))
               for name in sorted(per_call.keys() | recorded.keys())}
    dropped = {name: c for name, c in dropped.items() if c[0] != c[1]}
    if dropped or not recorded:
        return None, dropped
    us = sum(t / n * per_call[name] for name, (t, n) in recorded.items())
    return us / 1e3, {}


def counted_device_ms(many, iters, symbols=(), launched=None):
    """Device ms per call from one profile of ``iters`` calls (``many``,
    as ``device_kernels`` gives it), the expected launches taken from a
    launcher's own counter and not from a one-call profile: the kernels
    whose names hold one of ``symbols`` must number ``launched`` (the
    counter's growth over the profile) when it is given, and every name
    a whole number of launches a call. Returns (ms or None, {name or the
    symbols joined by "+": (launches recorded, launches expected)} where
    they differ): a profile that dropped or gained a launch gives None,
    never a low number; so does one with no device time."""
    dropped = {}
    if launched is not None:
        ours = sum(n for _, n, name in many if any(s in name for s in symbols))
        if ours != launched:
            dropped["+".join(symbols)] = (ours, launched)
    for _, n, name in many:
        if n % iters:
            dropped[name] = (n, -(-n // iters) * iters)
    if dropped or not many:
        return None, dropped
    return sum(us for us, _, _ in many) / iters / 1e3, {}


def report_dropped(dropped, label):
    """Print the launches a profile dropped (or gained), if any."""
    if dropped:
        print(f"profiler dropped events{' (' + label + ')' if label else ''}: "
              f"launches recorded / expected "
              f"{ {name[:60]: c for name, c in dropped.items()} }; "
              "device time not reported")


def device_ms(fn, iters=50, label=""):
    """Device time per call of ``fn`` (every kernel and copy it puts on
    the card) from the profiler, or None when the profiler recorded no
    device time or dropped events; the latter is printed."""
    fn()
    one = device_kernels(fn)
    many = device_kernels(lambda: [fn() for _ in range(iters)])
    ms, dropped = per_call_device_ms(one, many, iters)
    report_dropped(dropped, label)
    return ms


# Profiles a counted_ms takes at most while each drops a launch.
COUNTED_PROFILES = 3


def counted_ms(fn, iters=10, label="", launcher=None, symbols=()):
    """Device time per call of ``fn`` from one profile of ``iters`` calls,
    for a kernel whose one-call profile loses its launch (the training
    backwards): the kernels whose names hold one of ``symbols`` must
    number the growth of ``launcher.launches`` over the profile, or with
    no launcher (a library call) each name a whole number of launches a
    call (``counted_device_ms``). A profile that dropped a launch is
    taken again, up to COUNTED_PROFILES in all; then None is returned
    and the drop printed."""
    fn()
    for _ in range(COUNTED_PROFILES):
        before = None if launcher is None else launcher.launches
        many = device_kernels(lambda: [fn() for _ in range(iters)])
        ms, dropped = counted_device_ms(
            many, iters, tuple(symbols),
            None if launcher is None else launcher.launches - before)
        if not dropped:
            break
    report_dropped(dropped, label)
    return ms


def device_breakdown(run, wall_s, top=6, match=()):
    """The device's busy time in one call of ``run`` (kernels and copies),
    its idle share of ``wall_s`` (the same work timed without the
    profiler), the kernels and copies it put on the card, the kernels that
    take most, and the time and calls of the kernels whose names hold
    each string of ``match``."""
    kernels = device_kernels(run)
    busy_s = sum(k[0] for k in kernels) / 1e6
    return {"busy_ms": busy_s * 1e3, "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy_s / wall_s,
            "launches": sum(n for _, n, _ in kernels),
            "top": [{"kernel": name[:70], "ms": us / 1e3, "calls": n}
                    for us, n, name in kernels[:top]],
            "matched": {m: {"ms": sum(us for us, _, name in kernels if m in name) / 1e3,
                            "calls": sum(n for _, n, name in kernels if m in name)}
                        for m in match}}


def ptxas_summary(report: str) -> list:
    """[(kernel, "N registers; stack and spills")] from nvcc's -Xptxas -v
    output: each entry function's registers and its stack frame and
    spill line."""
    out, name, spill = [], None, {}
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line and i + 1 < len(lines):
            spill[line.rsplit(" ", 1)[-1]] = lines[i + 1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out.append((name, f"{regs}; {spill.get(name, 'no stack line')}"))
            name = None
    return out


# ----------------------------------------------------------------- phases --

def kernel_cases(torch, feats):
    """(label, x, k, quantize) on the card for the kernel-vs-plain phase."""
    gen = np.random.default_rng(0)

    def rows(l, n):
        return torch.from_numpy((gen.standard_normal((l, n)) * gen.uniform(
            0.1, 10.0, (l, 1))).astype(np.float32)).cuda()

    zero = rows(4, 1024)
    zero[1] = 0.0
    ties = rows(3, 1024)
    ties[2, :512] = 0.5
    ties[2, 512:] = 0.25
    codecs = {"int8": (None, True), "topk": ("k", False),
              "int8_topk": ("k", True), "identity": (None, False)}
    cases = []
    for label, x, k in [("serve_feat_2", rows(2, 1024), 256),
                        ("serve_feat_16", rows(16, 1024), 256),
                        ("serve_feat_64", rows(64, 1024), 256),
                        ("serve_scores_64", torch.rand(64, 25, device="cuda"), 7),
                        ("ragged_5x4097", rows(5, 4097), 1025),
                        ("zero_row", zero, 256), ("ties", ties, 256),
                        ("bf16_16x1024", rows(16, 1024).bfloat16(), 256),
                        ("encoder_h_a", feats[0], 256),
                        ("encoder_h_b", feats[1], 256)]:
        for codec, (kk, q) in codecs.items():
            cases.append((f"{label}/{codec}", x, k if kk else None, q))
    # the training round's messages: uplink (C=16 or K=4, leaf) and
    # downlink (1, leaf) at k = a quarter of the row, in f32 and bf16;
    # rows this wide take the multi-CTA select (a histogram kernel a digit
    # pass, merged across the row's CTAs in a workspace)
    for l, n in TRAIN_CODEC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = rows(l, n).to(dtype)
            for codec, (kk, q) in codecs.items():
                cases.append((f"train_{l}x{n}_{str(dtype)[6:]}/{codec}", x,
                              n // 4 if kk else None, q))
    return cases


def nan_equal(torch, a, b) -> bool:
    """Bit for bit, NaN as equal."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(bits), b[~nan].view(bits)))


def check_kernel(torch, ops, launcher, ref, x, k, quantize):
    """The codec on one message x (L, N): the fused op (selection and
    pass on the card) and the top-k composition (library top-k, then the
    pass kernel), each against the plain version. The fused op's
    [scale, thresh] and output must equal the plain version's bit for
    bit (NaN as equal); so must the pass's output. Returns the largest
    absolute difference seen."""
    st = ops.scale_thresh(x, k)
    xc = x.contiguous()
    got = launcher.wire_codec_cuda(xc, st, quantize=quantize)
    fused, fused_st = launcher.wire_codec_fused(xc, k=k, quantize=quantize)
    want = ref.wire_codec_ref(x, st, quantize=quantize)
    torch.cuda.synchronize()
    check(nan_equal(torch, fused_st, st), "the fused op's [scale, thresh] "
          "differ from the library top-k's")
    check(nan_equal(torch, fused, want), "the fused op differs from the plain version")
    g, w = got.float(), want.float()
    check(torch.equal(g != 0, w != 0), "keep-masks differ")
    scale = st[:, :1]
    err = float(max((g - w).abs().max(), (fused.float() - w).abs().max()))
    if quantize:
        check(torch.equal(torch.round(g * 127 / scale),
                          torch.round(w * 127 / scale)), "int8 codes differ")
        check(bool(((g - w).abs() <= 4 * EPS32 * scale).all()),
              f"values beyond 4 eps * scale: {err}")
    elif k is None:
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        check(torch.equal(got.view(bits), x.contiguous().view(bits)),
              "dense identity is not exact")
    else:
        check(err == 0.0, f"top-k without quantize differs: {err}")
    return err


def codec_kernels_a_call(torch, launcher, x, k, calls=10, attempts=3) -> dict:
    """{kernel or copy name: launches a call} that the fused codec puts on
    the card, and their device microseconds a call, from profiles of
    ``calls`` calls; the launches are held to what ``wire_codec.py``
    states: one ``narrow_kernel`` for N <= NARROW_MAX; else a memset,
    ``hist_kernel`` once a digit pass (3 sparse f32, 2 sparse bf16, 1
    dense) and one ``pass_kernel``. A name the statement lacks, or more
    launches than it states, fails. The profiler can lose launches (a
    profile of this script has recorded none): a profile short of the
    statement is taken again, and after ``attempts`` short ones the
    launches read None, with a ``profiler dropped events`` line."""
    rows, n = x.shape
    if n <= launcher.NARROW_MAX:
        want = {"narrow_kernel": 1}
    else:
        sparse = k is not None and k < n
        want = {"memset": 1, "hist_kernel": (3 if x.dtype == torch.float32 else 2)
                if sparse else 1, "pass_kernel": 1}
    for _ in range(attempts):
        got, us = {}, {}
        for t, c, name in device_kernels(lambda: [launcher.wire_codec_fused(
                x, k=k, quantize=True) for _ in range(calls)]):
            key = next((kn for kn in ("narrow_kernel", "hist_kernel", "pass_kernel")
                        if kn in name), "memset" if "emset" in name else name[:60])
            got[key] = got.get(key, 0) + c
            us[key] = us.get(key, 0.0) + t / calls
        check(set(got) <= set(want) and all(got[key] <= calls * want[key] for key in got),
              f"{calls} fused codec calls at {tuple(x.shape)} put {got} on the card, "
              f"want {calls} x {want}")
        if got == {key: calls * c for key, c in want.items()}:
            return {"calls": want, "device_us": us}
    print(f"profiler dropped events (fused codec at {tuple(x.shape)}): launches "
          f"recorded / expected {got} / {calls} x {want}")
    return {"calls": None, "device_us": None}


def time_codec(torch, ops, launcher, ref, x, k, mem_rate):
    """The codec at one message shape (quantize on, k as given): the fused
    op (what the main path calls), the top-k composition it replaced
    (``scale_thresh``'s library top-k, then the pass kernel), the pass
    alone given [scale, thresh], and the plain version, each per call;
    device times from the profiler; the HBM bound."""
    st = ops.scale_thresh(x, k)
    xc = x.contiguous()
    fused = lambda: launcher.wire_codec_fused(xc, k=k, quantize=True)  # noqa: E731
    composition = lambda: launcher.wire_codec_cuda(  # noqa: E731
        xc, ops.scale_thresh(xc, k), quantize=True)
    ms = cuda_time_ms(fused)
    pass_ms = cuda_time_ms(lambda: launcher.wire_codec_cuda(xc, st, quantize=True))
    composition_ms = cuda_time_ms(composition)
    plain_ms = cuda_time_ms(lambda: ref.wire_codec_ref(
        xc, ops.scale_thresh(xc, k), quantize=True))
    rows, n = x.shape
    nbytes = rows * n * 2 * x.element_size() + rows * 8
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = CODEC_OPS_PER_ELEM * rows * n / FP32_OPS_PER_S * 1e3
    return {"shape": [rows, n], "dtype": str(x.dtype).replace("torch.", ""),
            "k": k, "ms": ms, "pass_ms": pass_ms, "composition_ms": composition_ms,
            "plain_ms": plain_ms, "device_ms": device_ms(fused, label="fused codec"),
            "pass_device_ms": device_ms(lambda: launcher.wire_codec_cuda(
                xc, st, quantize=True), label="codec pass"),
            "composition_device_ms": device_ms(composition, label="composition"),
            "kernels_a_call": codec_kernels_a_call(torch, launcher, xc, k),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def print_codec_time(t):
    print(f"wire_codec {t['shape']} {t['dtype']} k={t['k']}: fused op "
          f"{t['ms']:.5f} ms a call (device {t['device_ms']} ms; kernels a "
          f"call {t['kernels_a_call']}); top-k composition (library top-k + "
          f"pass) {t['composition_ms']:.5f} ms (device "
          f"{t['composition_device_ms']} ms); pass alone {t['pass_ms']:.5f} ms "
          f"(device {t['pass_device_ms']} ms); plain {t['plain_ms']:.5f} ms; "
          f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})")


def rotation(make, nbytes):
    """Copies of the inputs ``make()`` returns, enough to span
    ROTATE_BYTES (at most 64), and a function that hands them out in
    turn."""
    n = max(1, min(64, int(np.ceil(ROTATE_BYTES / nbytes))))
    copies = [make() for _ in range(n)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return copies[state["i"]]

    return nxt


def blend_inputs(torch, l, n, seed, dtype=None, zero=True):
    """(L, N) normal rows on the card and an f32 omega summing to one,
    with a discarded (zero) candidate when ``zero``."""
    gen = np.random.default_rng(seed)
    x = torch.from_numpy(gen.standard_normal((l, n), np.float32)).cuda()
    omega = gen.random(l).astype(np.float32)
    if zero and l > 1:
        omega[gen.integers(l)] = 0.0
    omega = torch.from_numpy(omega / omega.sum()).cuda()
    return (x if dtype is None else x.to(dtype)), omega


# the wire codec's messages in a full-width codec round: the largest
# uplink leaf, the largest downlink leaf, and f_*/in/w; then the uplink
# leaves of a K = 4 sampled round (phase 17), the K rows of each
TRAIN_CODEC_SHAPES = ((16, 1048576), (1, 2097152), (16, 131072),
                      (4, 1048576), (4, 131072))

# the leaf shapes of one full-width round's blends (C = 16 clients, the
# server head stacked onto g_M), then the CPU tests' shapes
BLEND_MAIN_SHAPES = ((16, 1048576), (17, 2097152), (16, 131072), (16, 1024))
BLEND_TEST_SHAPES = ((3, 1000), (5, 2048), (2, 33), (7, 4097))
# a K = 4 sampled round's blends: the largest leaves of the A and B
# groups (K rows) and of g_M (K + 1 rows, the server head stacked on),
# then two more row counts of that order
BLEND_SAMPLED_SHAPES = ((4, 1048576), (5, 2097152), (4, 2097152), (5, 262144))


def check_blend(torch, blaunch, bref, x, omega):
    got = blaunch.blend_params_cuda(x, omega)
    want = bref.blend_params_ref(x, omega)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = bref.blend_error_bound(x, omega, want, got)
    check(got.dtype == x.dtype and tuple(got.shape) == (x.shape[1],),
          "blend output dtype or shape")
    check(bool((err <= bound).all()), f"blend beyond its bound: max err "
          f"{float(err.max())}, bound there {float(bound[err.argmax()])}")
    return float(err.max())


def time_blend(torch, blaunch, bref, l, n, mem_rate):
    nbytes = l * n * 4
    nxt = rotation(lambda: blend_inputs(torch, l, n, seed=l + n), nbytes)
    ms = cuda_time_ms(lambda: blaunch.blend_params_cuda(*nxt()))
    plain_ms = cuda_time_ms(lambda: bref.blend_params_ref(*nxt()))
    library_ms = cuda_time_ms(lambda: (lambda x, om: om @ x)(*nxt()))
    kernel_device_ms = device_ms(lambda: blaunch.blend_params_cuda(*nxt()))
    plain_device_ms = device_ms(lambda: bref.blend_params_ref(*nxt()))
    library_device_ms = device_ms(lambda: (lambda x, om: om @ x)(*nxt()))
    bytes_ms = (nbytes + n * 4 + l * 4) / mem_rate * 1e3
    ops_ms = BLEND_OPS_PER_ELEM * l * n / FP32_OPS_PER_S * 1e3
    return {"shape": [l, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": kernel_device_ms,
            "plain_device_ms": plain_device_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def round_blend(torch, blaunch, bref, spec, ecfg, mem_rate) -> dict:
    """Phase 6's full-width round: the three group trees a round blends
    (f_A + g_A and f_B + g_B at 16 rows, g_M at 17: 13, 13 and 4 leaves,
    normal values from a seed), each blended in one launch through
    ``blend_params``, held bit for bit against one-leaf launches of the
    same kernel and within ``blend_error_bound`` of the plain version;
    then timed per round (three calls) beside the 30 one-leaf launches
    (one launch a leaf), the 30 per-leaf ``omega @ stacked`` and the
    bound, with device times; and the host time of entering
    ``torch.cuda.device`` around a launch, which the launchers now skip
    where the device is already current."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.encoders import init_client_models
    from repro_torch.kernels import on_device
    from repro_torch.kernels.blendavg.ops import blend_params

    gen = torch.Generator(device="cuda").manual_seed(11)
    one = init_client_models(torch.Generator().manual_seed(0), spec, ecfg,
                             device="cpu")
    groups, omegas = {}, {}
    for m, keys, rows in (("A", ("f_A", "g_A"), 16), ("B", ("f_B", "g_B"), 16),
                          ("M", ("g_M",), 17)):
        groups[m] = {k: [torch.randn((rows,) + tuple(x.shape), generator=gen,
                                     device="cuda") for x in tree_leaves(one[k])]
                     for k in keys}
        w = torch.rand(rows, generator=gen, device="cuda")
        omegas[m] = w / w.sum()
    del one
    flat = [(x, omegas[m]) for m in groups for x in tree_leaves(groups[m])]
    blaunch.launches = 0
    trees = {m: blend_params(groups[m], omegas[m]) for m in groups}
    launches = blaunch.launches
    check(launches == 3, f"a round's three group trees took {launches} launches")
    err = 0.0
    for m in groups:
        for x, g in zip(tree_leaves(groups[m]), tree_leaves(trees[m])):
            x2 = x.reshape(x.shape[0], -1)
            single = blaunch.blend_params_cuda(x2, omegas[m])
            check(torch.equal(g.reshape(-1), single),
                  f"group {m}: the tree launch differs from a one-leaf launch")
            want = bref.blend_params_ref(x2, omegas[m])
            e = (single - want).abs()
            check(bool((e <= bref.blend_error_bound(x2, omegas[m], want, single)).all()),
                  f"group {m}: tree blend beyond its bound")
            err = max(err, float(e.max()))
    del trees

    def tree_round():
        return [blend_params(groups[m], omegas[m]) for m in groups]

    def leaf_round():
        return [blaunch.blend_params_cuda(x.reshape(x.shape[0], -1), w) for x, w in flat]

    def cublas_round():
        return [w @ x.reshape(x.shape[0], -1) for x, w in flat]

    def plain_round():
        return [bref.blend_params_ref(x.reshape(x.shape[0], -1), w) for x, w in flat]

    dev = torch.device("cuda", torch.cuda.current_device())
    host = {}
    for label, ctx in (("torch.cuda.device", lambda: torch.cuda.device(dev)),
                       ("on_device (current)", lambda: on_device(dev))):
        t0 = time.perf_counter()
        for _ in range(20000):
            with ctx():
                pass
        host[label] = (time.perf_counter() - t0) / 20000 * 1e6
    nbytes = sum(x.numel() * 4 + x[0].numel() * 4 + x.shape[0] * 4 for x, _ in flat)
    out = {"launches": launches, "leaves": len(flat), "max_abs_err": err,
           "ms": cuda_time_ms(tree_round, iters=50, warmup=3),
           "one_leaf_launches_ms": cuda_time_ms(leaf_round, iters=50, warmup=3),
           "library_ms": cuda_time_ms(cublas_round, iters=50, warmup=3),
           "plain_ms": cuda_time_ms(plain_round, iters=10, warmup=1),
           "device_ms": device_ms(tree_round, iters=10, label="tree blend"),
           "one_leaf_device_ms": device_ms(leaf_round, iters=10, label="one-leaf blends"),
           "library_device_ms": device_ms(cublas_round, iters=10, label="omega @ stacked"),
           "host_us_entering": host,
           "bound_ms": nbytes / mem_rate * 1e3, "bound_by": "bytes"}
    print(f"full round's blends (A, B, M trees of 13, 13, 4 leaves): {launches} "
          f"launches, equal to one-leaf launches bit for bit, max abs err vs "
          f"plain {err:.3g}; {out['ms']:.5f} ms a round (device {out['device_ms']} "
          f"ms) against 30 one-leaf launches {out['one_leaf_launches_ms']:.5f} ms "
          f"(device {out['one_leaf_device_ms']} ms), 30 x omega @ stacked "
          f"{out['library_ms']:.5f} ms (device {out['library_device_ms']} ms), "
          f"plain {out['plain_ms']:.5f} ms; bound {out['bound_ms']:.6f} ms (bytes); "
          f"host us entering a device context: "
          f"{ {k: round(v, 3) for k, v in host.items()} }")
    del groups, flat
    torch.cuda.empty_cache()
    return out


def time_train_codec(torch, ops, wlaunch, wref, rows, n, mem_rate):
    """The wire codec at one training message shape (k = a quarter of
    the row, the codec's default topk_frac), inputs rotated over
    ROTATE_BYTES: the fused op, the top-k composition (library top-k,
    then the pass kernel), the pass alone given [scale, thresh] and the
    plain version, each per call; device times; the bound."""
    from repro_torch.core.codec import topk_k

    k = topk_k(n, 0.25)
    nbytes = rows * n * 4

    def make():
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (rows, n), np.float32)).cuda()
        return x, ops.scale_thresh(x, k)

    nxt = rotation(make, nbytes)

    def fused():
        return wlaunch.wire_codec_fused(nxt()[0], k=k, quantize=True)

    def composition():
        x = nxt()[0]
        return wlaunch.wire_codec_cuda(x, ops.scale_thresh(x, k), quantize=True)

    ms = cuda_time_ms(fused, iters=50, warmup=3)
    pass_ms = cuda_time_ms(lambda: wlaunch.wire_codec_cuda(*nxt(), quantize=True),
                           iters=50, warmup=3)
    composition_ms = cuda_time_ms(composition, iters=20, warmup=2)
    plain_ms = cuda_time_ms(lambda: (lambda x: wref.wire_codec_ref(
        x, ops.scale_thresh(x, k), quantize=True))(nxt()[0]), iters=20, warmup=2)
    bytes_ms = (nbytes * 2 + rows * 8) / mem_rate * 1e3
    ops_ms = CODEC_OPS_PER_ELEM * rows * n / FP32_OPS_PER_S * 1e3
    return {"shape": [rows, n], "dtype": "float32", "k": k, "ms": ms,
            "pass_ms": pass_ms, "composition_ms": composition_ms,
            "plain_ms": plain_ms,
            "device_ms": device_ms(fused, iters=20, label="fused codec"),
            "pass_device_ms": device_ms(lambda: wlaunch.wire_codec_cuda(
                *nxt(), quantize=True), iters=20, label="codec pass"),
            "composition_device_ms": device_ms(composition, iters=20,
                                               label="composition"),
            "kernels_a_call": codec_kernels_a_call(torch, wlaunch, nxt()[0], k),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def timed_phases(torch, fed):
    """Wrap the federation's phase methods so that each round records
    the host seconds of each phase, each ending in a device sync."""
    secs = {}
    for name in ("_unimodal_phase", "_vfl_phase", "_paired_phase", "_aggregate"):
        def wrapped(*a, _orig=getattr(fed, name), _key=name.strip("_"), **k):
            t0 = time.perf_counter()
            out = _orig(*a, **k)
            torch.cuda.synchronize()
            secs[_key] = time.perf_counter() - t0
            return out
        setattr(fed, name, wrapped)
    return secs


def group_leaves(tree_leaves, models) -> dict:
    """Leaves each BlendAvg group blends: f_A+g_A, f_B+g_B, g_M."""
    return {"A": len(tree_leaves(models["f_A"])) + len(tree_leaves(models["g_A"])),
            "B": len(tree_leaves(models["f_B"])) + len(tree_leaves(models["g_B"])),
            "M": len(tree_leaves(models["g_M"]))}


def blended(logs) -> list:
    """The groups a round blended (a group whose omegas are all zero
    keeps the global model and launches nothing)."""
    return [m for m in "ABM" if float(np.sum(logs[f"omega_{m}"])) > 0]


def training_data(spec):
    """The full-width federation's data (phases 7 and 17): 8192 training
    rows over 16 clients, a 1024-row validation and test set."""
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import train_val_test

    tr, va, te = train_val_test(spec, 8192, 1024, 1024, seed=0)
    return partition(tr, 16, seed=1), va, te


def full_width_training(torch, spec, ecfg, blaunch, bref, wlaunch, ops, wref,
                        mem_rate) -> dict:
    """Phase 7: BlendFL rounds at full width on the card (see the module
    docstring). Returns the numbers the kernels line and PERF.md need."""
    import dataclasses

    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.engine import CLIENT_GROUPS
    from repro_torch.core.federation import FedConfig, Federation, evaluate_global

    t0 = time.perf_counter()
    clients, va, te = training_data(spec)
    cfg = FedConfig(n_clients=16, rounds=3, lr=1e-2, batch_size=64)
    fed = Federation.init(torch.Generator().manual_seed(0), cfg, spec, ecfg,
                          clients, va, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(fed.global_models))
    leaves = group_leaves(tree_leaves, fed.global_models)
    print(f"data + init {time.perf_counter() - t0:.2f} s: 16 clients, "
          f"{n_params} parameters a client, leaves per group {leaves}, "
          f"unimodal rows {tuple(fed.data['uni']['ma'].shape)}, paired "
          f"{tuple(fed.data['paired']['m'].shape)}, VFL aligned rows "
          f"{len(fed.data['vfl']['gather_a'])}")
    check(leaves == {"A": 13, "B": 13, "M": 4}, f"leaves per group {leaves}")
    secs = timed_phases(torch, fed)

    captured = []  # round 0's blends, held against the plain version below
    blend_stacked = fed.engine.fns.blend_stacked

    def capture(stacked, omega):
        out = blend_stacked(stacked, omega)
        captured.append((stacked, omega, out))
        return out

    launches, walls = 0, []
    torch.cuda.reset_peak_memory_stats()
    for r in range(cfg.rounds):
        if r == 0:
            fed.engine.fns.blend_stacked = capture
        blaunch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = fed.round()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fed.engine.fns.blend_stacked = blend_stacked
        got = blaunch.launches
        launches += got
        groups = blended(logs)
        if r == 0:
            groups0 = groups
        want = sum(blaunch.launches_for(leaves[m]) for m in groups)
        losses = {k: logs[k] for k in ("loss_partial", "loss_vfl", "loss_paired")}
        print(f"round {r}: {walls[-1]:.3f} s wall; phases "
              f"{ {k: round(v, 4) for k, v in secs.items()} } s; losses "
              f"{ {k: round(v, 5) for k, v in losses.items()} }")
        for m in "ABM":
            print(f"    omega_{m} {np.round(np.asarray(logs[f'omega_{m}']), 4).tolist()}")
        print(f"    blended groups {groups}: {got} blend launches (want {want})")
        check(all(np.isfinite(v) for v in losses.values()), f"round {r}: losses {losses}")
        check(got == want, f"round {r}: {got} blend launches, want {want}")

    check(launches > 0, "the training rounds launched no blend kernel")
    check(len(captured) == len(groups0), f"captured {len(captured)} blends")
    err = 0.0
    for stacked, omega, out in captured:
        om = torch.as_tensor(np.asarray(omega, np.float32), device="cuda")
        for x, g in zip(tree_leaves(stacked), tree_leaves(out)):
            flat = x.reshape(x.shape[0], -1)
            want = bref.blend_params_ref(flat, om)
            e = (g.reshape(-1) - want).abs()
            check(bool((e <= bref.blend_error_bound(flat, om, want,
                                                    g.reshape(-1))).all()),
                  "round 0's blend beyond its bound against the plain version")
            err = max(err, float(e.max()))
    print(f"round 0's {len(captured)} blended groups match the plain version "
          f"on the card; max abs err {err:.3g}")
    del captured

    ev = evaluate_global(fed, te)
    print(f"evaluate_global after {cfg.rounds} rounds: "
          f"{ {k: round(v, 4) for k, v in ev.items()} }")
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in ev.values()),
          f"evaluate_global {ev}")

    bd = device_breakdown(lambda: fed.round(), walls[-1], match=("blend_kernel",))
    print(f"profiled round: device busy {bd['busy_ms']:.2f} ms of "
          f"{bd['wall_ms']:.2f} ms wall, idle share {bd['idle_share']:.3f}; "
          f"blend kernel {bd['matched']['blend_kernel']['ms']:.4f} ms in "
          f"{bd['matched']['blend_kernel']['calls']} launches; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for k in bd["top"]:
        print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x {k['kernel']}")

    # one more round under the int8_topk codec, from the trained globals
    base = fed.global_models
    n_msg = len(tree_leaves({k: base[k] for k in CLIENT_GROUPS}))
    del fed
    torch.cuda.empty_cache()
    fed_c = Federation.init(torch.Generator().manual_seed(0),
                            dataclasses.replace(cfg, codec="int8_topk"), spec,
                            ecfg, clients, va, device="cuda", base=base)
    wlaunch.launches = blaunch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = fed_c.round()
    torch.cuda.synchronize()
    codec_wall = time.perf_counter() - t0
    codec_launches = wlaunch.launches
    want = sum(blaunch.launches_for(leaves[m]) for m in blended(logs))
    print(f"int8_topk round: {codec_wall:.3f} s wall; losses "
          f"{[round(logs[k], 5) for k in ('loss_partial', 'loss_vfl', 'loss_paired')]}; "
          f"{codec_launches} wire_codec launches (want 2 x {n_msg}); "
          f"{blaunch.launches} blend launches (want {want})")
    check(codec_launches == 2 * n_msg, f"{codec_launches} wire_codec launches")
    check(blaunch.launches == want, f"{blaunch.launches} blend launches")
    check(all(np.isfinite(logs[k]) for k in ("loss_partial", "loss_vfl", "loss_paired")),
          "int8_topk round: losses")
    del fed_c
    torch.cuda.empty_cache()

    codec_times = [time_train_codec(torch, ops, wlaunch, wref, rows, n, mem_rate)
                   for rows, n in ((16, 1048576), (1, 2097152))]
    for t in codec_times:
        print_codec_time(t)
    return {"launches": launches, "round_wall_s": walls, "breakdown": bd,
            "codec_launches": codec_launches, "codec_round_s": codec_wall,
            "codec_times": codec_times, "evaluate_global": ev,
            "data": (clients, va), "test": te}


def server_moments(srv) -> dict:
    """A server optimizer's state as it is compared: m, the step t, and
    adam's v as sqrt(v), a weighted L2 norm of the blended deltas that
    moves no more than they do (v itself, about 0.01 * delta^2, lies
    below any atol that suits the deltas)."""
    from repro_torch.common.tree import tree_map

    out = {"m": srv["m"], "t": srv["t"]}
    if "v" in srv:
        out["sqrt_v"] = tree_map(lambda v: v.sqrt(), srv["v"])
    return out


def pair_flips(y, card, cpu) -> tuple:
    """(positive, negative) pairs of each label of ``y`` (N, L) that two
    runs' score arrays (lists of (N, L) arrays, one a scoring call) order
    differently, ties counting as an order of their own, summed over the
    calls; and the largest |score gap| of such a pair in the second run."""
    n, gap = 0, 0.0
    for a, b in zip(card, cpu):
        for c in range(y.shape[1]):
            pos, neg = y[:, c] == 1, y[:, c] == 0
            da = a[pos, c][:, None] - a[neg, c][None, :]
            db = b[pos, c][:, None] - b[neg, c][None, :]
            flip = np.sign(da) != np.sign(db)
            n += int(flip.sum())
            gap = max(gap, float(np.abs(db[flip]).max(initial=0.0)))
    return n, gap


def card_vs_cpu(torch, rounds=2, data_seed=0, enc_type="mlp", **kw) -> dict:
    """Phase 8: the quickstart-shaped federation on the card and on the
    CPU, from the same weights and shuffles (both draw them from
    CPU generators seeded alike), held to the CPU parity tolerances;
    ``kw`` goes to ``FedConfig`` (3 clients unless it says otherwise),
    ``data_seed`` to the data, ``enc_type`` to the encoders (4 heads of
    12 for the recurrent and transformer ones: phase 22).
    A sampled round's ids must be equal on both. The smallest BlendAvg
    delta of the CPU run is printed: a delta within the card's rounding
    of 0 could flip an omega mask (ROADMAP fault (d)). So are the
    validation AUROC's (positive, negative) pairs that the card and the
    CPU order differently, over every scoring call, and the widest score
    gap of such a pair on the CPU: each pair moves that label's AUROC by
    1 / (n_pos n_neg), and through Eq. 9-10 the omegas. Each gap is also
    printed as a share of its tolerance ("... of tolerance": the losses'
    of LOSS_RTOL, the omegas' of OMEGA_ATOL, a tree's largest |card -
    cpu| / (atol + PARAM_RTOL |cpu|)), the room the check has left.
    After an adam server step the params' atol is scaled by server_lr /
    SERVER_EPS, the step's largest gain on a small delta. SCAFFOLD's control variates are
    held to rtol 1e-4, atol 1e-3, since SCAFFOLD divides the trained
    weights' difference by steps * lr; the server optimizer's m, sqrt(v)
    and step to the params' tolerance without adam's gain, which in an
    async round a straggler's stale base carries into the blended delta
    (the tolerances of tests/test_torch_strategies.py and
    tests/_torch_parity.server_moments)."""
    import repro_torch.core.federation as fed_mod
    from repro_torch.common.tree import tree_leaves
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.aggregate import SERVER_EPS
    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.core.federation import FedConfig, Federation, evaluate_global
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import make_task, train_val_test

    spec = make_task("smnist")
    tr, va, te = train_val_test(spec, 500, 300, 300, seed=data_seed)
    cfg = FedConfig(**{"n_clients": 3, "rounds": rounds, "lr": 1e-2,
                       "batch_size": 64, **kw})
    clients = partition(tr, cfg.n_clients, frac_paired=0.4,
                        frac_fragmented=0.3, frac_partial=0.3)
    lossy = cfg.codec != "none"
    atol = PARAM_ATOL
    if cfg.server_opt == "adam":
        atol *= cfg.server_lr / SERVER_EPS
    ecfg = EncoderConfig(d_hidden=48, n_layers=2, enc_type=enc_type)
    feds = [Federation.init(torch.Generator().manual_seed(0), cfg, spec, ecfg,
                            clients, va, device=dev) for dev in ("cuda", "cpu")]
    weights, margins = fed_mod.blendavg_weights, []
    auroc, scored = fed_mod.auroc, ([], [])  # each run's validation scores

    def recording(scores, global_score, **k):  # the CPU run's deltas
        d = np.asarray(scores, np.float64) - global_score
        margins.append(float(np.abs(d[np.isfinite(d)]).min(initial=np.inf)))
        return weights(scores, global_score, **k)

    def scoring(calls):
        def rec(y, s):
            calls.append(np.array(s, np.float64))
            return auroc(y, s)
        return rec

    worst = {"loss": 0.0, "omega": 0.0}
    sampled = []
    for r in range(cfg.rounds):
        fed_mod.auroc = scoring(scored[0])
        try:
            card = feds[0].round()
        finally:
            fed_mod.auroc = auroc
        fed_mod.blendavg_weights, fed_mod.auroc = recording, scoring(scored[1])
        try:
            cpu = feds[1].round()
        finally:
            fed_mod.blendavg_weights, fed_mod.auroc = weights, auroc
        if "sampled" in cpu:
            check(np.array_equal(card["sampled"], cpu["sampled"]),
                  f"round {r}: card sampled {card['sampled']}, cpu "
                  f"{cpu['sampled']}")
            sampled.append(card["sampled"].tolist())
        for k in ("loss_partial", "loss_vfl", "loss_paired"):
            if np.isnan(cpu[k]):  # no rows took part in this phase
                check(np.isnan(card[k]), f"round {r} {k}: card {card[k]}")
                continue
            rel = abs(card[k] - cpu[k]) / abs(cpu[k])
            worst["loss"] = max(worst["loss"], rel)
            check(np.isfinite(card[k]) and rel <= LOSS_RTOL,
                  f"round {r} {k}: card {card[k]} cpu {cpu[k]}")
        for m in "ABM":
            if f"omega_{m}" not in cpu:
                continue
            a, b = np.asarray(card[f"omega_{m}"]), np.asarray(cpu[f"omega_{m}"])
            worst["omega"] = max(worst["omega"], float(np.abs(a - b).max()))
            check(np.allclose(a, b, rtol=0, atol=OMEGA_ATOL)
                  and (a.sum() == 0) == (b.sum() == 0),
                  f"round {r} omega_{m}: card {a} cpu {b}")
    trees = [("global params", [f.global_models for f in feds], atol)]
    if lossy:
        trees.append(("downlink residual", [f.resid_down for f in feds], atol))
    states = [f.strat_state or {} for f in feds]
    if "c_local" in states[1]:
        trees.append(("control variates", [{k: st[k] for k in (
            "c_global", "c_local")} for st in states], 1e-3))
    if "srv" in states[1]:
        trees.append(("server optimizer", [server_moments(st["srv"])
                                           for st in states],
                      atol if cfg.async_mode else PARAM_ATOL))
    for name, (ta, tb), tol in trees:
        pairs = list(zip(tree_leaves(params_to_numpy(ta)),
                         tree_leaves(params_to_numpy(tb))))
        d = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
        worst[name] = float(d.max())
        if lossy:
            share = float((d <= PARAM_ATOL).mean())
            worst[f"{name} share within {PARAM_ATOL}"] = share
            check(d.max() <= LOSSY_MAX_ABS and share >= LOSSY_SHARE,
                  f"{name}: card vs CPU max {d.max()}, share {share}")
        else:
            worst[f"{name} of tolerance"] = max(
                float(np.max(np.abs(a - b) / (tol + PARAM_RTOL * np.abs(b)),
                             initial=0.0)) for a, b in pairs)
            check(all(np.allclose(a, b, rtol=PARAM_RTOL, atol=tol)
                      for a, b in pairs),
                  f"{name}: card vs CPU beyond tolerance")
    worst["loss of tolerance"] = worst["loss"] / LOSS_RTOL
    worst["omega of tolerance"] = worst["omega"] / OMEGA_ATOL
    for f in feds[1:]:
        check(np.array_equal(feds[0].last_round, f.last_round)
              and np.array_equal(feds[0].part_count, f.part_count),
              "last_round / part_count differ card vs CPU")
    ea, eb = (evaluate_global(f, te) for f in feds)
    worst["eval"] = max(abs(ea[k] - eb[k]) for k in ea)
    if not lossy:
        check(worst["eval"] <= EVAL_ATOL, f"evaluate_global: card {ea} cpu {eb}")
    worst["smallest_delta"] = min(margins, default=float("nan"))
    check(len(scored[0]) == len(scored[1]),
          f"{len(scored[0])} scoring calls on the card, {len(scored[1])} on the CPU")
    worst["auroc_pair_flips"], worst["widest_flip_gap"] = pair_flips(
        np.asarray(va.y), scored[0], scored[1])
    print(f"card vs CPU, {enc_type}, {cfg.rounds} round(s), {kw or 'blendavg'}: "
          f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} }; "
          f"multimodal AUROC {ea['multimodal_auroc']:.4f}"
          + (f"; sampled {sampled}" if sampled else ""))
    return worst



# Phase 17: K = 4 of the 16 clients a round. The strategies' runs, each
# one round: (label, FedConfig knobs).
SAMPLED_K = 4
SAMPLED_STRATEGIES = (
    ("fedavg", dict(strategy="fedavg")),
    ("fedprox", dict(strategy="fedprox", fedprox_mu=0.01)),
    ("scaffold", dict(strategy="scaffold")),
    ("fedavg+adam", dict(strategy="fedavg", server_opt="adam")),
    ("fedavg+momentum", dict(strategy="fedavg", server_opt="momentum")),
    ("median", dict(strategy="median")),
    ("trimmed_mean", dict(strategy="trimmed_mean", n_malicious=1)),
    ("krum", dict(strategy="krum", n_malicious=1)),
)
SAMPLED_POLICIES = ("round_robin", "staleness", "omega_ema", "data_volume")


def vfl_live(fed, ids) -> bool:
    """Whether any aligned VFL row has both owners among ``ids`` (else a
    sampled round has no VFL batch and its ``loss_vfl`` is NaN)."""
    host = fed.data["vfl_host"]
    on = np.zeros(fed.cfg.n_clients, bool)
    on[ids] = True
    return bool((on[host["gather_a"] // host["nfa"]]
                 & on[host["gather_b"] // host["nfb"]]).any())


def expected_blends(fed, logs, leaves) -> int:
    """Blend launches a round should make: one a group tree that blended
    (``launches_for`` its leaves: one up to 64). BlendAvg blends a group
    where some omega is positive; the weighted strategies and krum blend
    every group that ran (fedavg's path blends, then keeps the global
    where no weight is positive); median and trimmed_mean reduce by order
    statistics and blend none."""
    from repro_torch.kernels.blendavg.blendavg import launches_for

    scfg = fed.engine.cfg.strategy
    if scfg.name in ("median", "trimmed_mean"):
        return 0
    if scfg.score_based:
        return sum(launches_for(leaves[m]) for m in blended(logs))
    return sum(launches_for(leaves[m]) for m in "ABM" if f"omega_{m}" in logs)


def sampled_training(torch, spec, ecfg, data, counted, full_round_s) -> dict:
    """Phase 17: full-width sampled and strategy rounds on the card (the
    federation of phase 7 at K = 4): async BlendAvg rounds, the other
    participation policies, every strategy and server optimizer, and a
    sampled async int8_topk round. Every count is set to 0 just before
    each round and read just after it."""
    import dataclasses
    import gc

    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.engine import CLIENT_GROUPS
    from repro_torch.core.federation import FedConfig, Federation

    clients, va = data
    base_cfg = FedConfig(n_clients=16, rounds=1, lr=1e-2, batch_size=64,
                         n_sampled=SAMPLED_K)
    full = float(np.median(full_round_s))
    totals = {name: 0 for name in counted}
    out = {"runs": {}, "full_round_s": full}

    def run(label, rounds=1, keep=False, **kw):
        cfg = dataclasses.replace(base_cfg, rounds=rounds, **kw)
        gc.collect()  # the last run's federation (its timed phases hold it)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the kept async federation
        fed = Federation.init(torch.Generator().manual_seed(0), cfg, spec,
                              ecfg, clients, va, device="cuda")
        leaves = group_leaves(tree_leaves, fed.global_models)
        n_msg = len(tree_leaves({k: fed.global_models[k] for k in CLIENT_GROUPS}))
        secs = timed_phases(torch, fed)
        rec = {"rounds": []}
        for r in range(rounds):
            before = fed.last_round.copy()
            for m in counted.values():
                m.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = fed.round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {name: m.launches for name, m in counted.items()}
            for name, n in got.items():
                totals[name] += n
            ids = np.asarray(logs["sampled"])
            stale = np.maximum(r - 1 - before[ids], 0)
            losses = {k: logs[k] for k in ("loss_partial", "loss_vfl", "loss_paired")}
            want = {name: 0 for name in counted}
            want["blend_params"] = expected_blends(fed, logs, leaves)
            if cfg.codec != "none":
                want["wire_codec"] = 2 * n_msg
            changed = np.flatnonzero(fed.last_round != before)
            print(f"{label} round {r}: {wall:.3f} s wall ({wall / full:.3f} of a "
                  f"full round); phases { {k: round(v, 4) for k, v in secs.items()} } "
                  f"s; ids {ids.tolist()}, staleness {stale.tolist()}; "
                  f"losses { {k: round(v, 5) for k, v in losses.items()} }; "
                  f"launches {got}")
            if fed.engine.cfg.strategy.score_based:
                print("    omegas " + "; ".join(
                    f"{m} {np.round(np.asarray(logs[f'omega_{m}']), 4).tolist()}"
                    for m in "ABM" if f"omega_{m}" in logs))
            check(len(ids) == SAMPLED_K and len(np.unique(ids)) == SAMPLED_K,
                  f"{label}: sampled {ids}")
            check(np.isfinite(losses["loss_partial"])
                  and np.isfinite(losses["loss_paired"])
                  and np.isfinite(losses["loss_vfl"]) == vfl_live(fed, ids),
                  f"{label} round {r}: losses {losses}")
            check(got == want, f"{label} round {r}: launches {got}, want {want}")
            if cfg.async_mode:
                check(np.array_equal(changed, np.sort(ids))
                      and (fed.last_round[ids] == r).all(),
                      f"{label} round {r}: last_round moved at {changed}, "
                      f"sampled {ids}")
            else:
                check((fed.last_round == r).all(), f"{label}: last_round")
            rec["rounds"].append({"wall_s": wall, "phase_s": dict(secs),
                                  "ids": ids.tolist(),
                                  "staleness": stale.tolist(),
                                  "launches": got, "losses": losses})
        rec["peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        rec["last_round"] = fed.last_round.tolist()
        print(f"{label}: peak memory {rec['peak_gb']:.2f} GB; last_round "
              f"{rec['last_round']}")
        out["runs"][label] = rec
        return fed if keep else None

    fed = run("async blendavg", rounds=3, keep=True, async_mode=True)
    stale = [s for r in out["runs"]["async blendavg"]["rounds"]
             for s in r["staleness"]]
    check(max(stale) > 0, "three async rounds saw no stale client")
    for policy in SAMPLED_POLICIES:
        run(f"policy {policy}", async_mode=True, policy=policy)
    for label, kw in SAMPLED_STRATEGIES:
        run(label, **kw)
    run("async int8_topk", async_mode=True, codec="int8_topk")
    out["launches"] = totals
    walls = [r["wall_s"] for r in out["runs"]["async blendavg"]["rounds"]]
    # the async run's next round under the profiler, last, so that no
    # timed round follows the profiler: busy time and idle share
    out["breakdown"] = device_breakdown(lambda: fed.round(), walls[-1],
                                        match=("blend_kernel",))
    print_breakdown("async blendavg, a profiled round", out["breakdown"])
    del fed
    print(f"K = {SAMPLED_K} async BlendAvg rounds {np.round(walls, 4).tolist()} s "
          f"against the full round's {full:.4f} s (median of phase 7): "
          f"{np.round(np.asarray(walls) / full, 3).tolist()}; launches over "
          f"the phase {totals}")
    return out


MIXES = ("all_multimodal", "mixed_unimodal", "vfl_heavy")
# Stand-ins for the reference's hash(mix), which Python salts per
# process: with them every run serves the same streams.
MIX_SALT = {"all_multimodal": 101, "mixed_unimodal": 202, "vfl_heavy": 303}


def print_breakdown(label, bd):
    print(f"{label}: device busy {bd['busy_ms']:.2f} ms of "
          f"{bd['wall_ms']:.2f} ms wall, idle share {bd['idle_share']:.3f}, "
          f"{bd['launches']} kernels and copies")
    for k in bd["top"]:
        print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x {k['kernel']}")


def full_width_serving(torch, spec, ecfg, models, gmv, launchers,
                       seed=0, requests=64) -> dict:
    """Serve the three mixes (``requests`` requests of 1..64 rows each,
    streams fixed by ``seed`` and MIX_SALT) through one ``ServingEngine``
    (int8_topk codec, capacities 2/4/16/64) on the card, counting the
    launches of each module in ``launchers`` over the run. Then serve the
    same streams again recording each VFL row's wire messages, which must
    give the same scores, and check every result: route, shape, finite
    scores in [0, 1], agreement with single-request ``predict`` on the
    card and with the same models on the CPU, within
    ``serve_federated.within_tolerance`` (a large error on the lossy
    route only in a row whose wire messages differ, and such rows at most
    MAX_FLIPPED_RECURRENT of the recurrent encoder's card-vs-CPU rows,
    else MAX_FLIPPED); and the measured wire bytes against the analytic
    cost."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.inference import (InferenceRequest, Route,
                                            communication_cost, predict,
                                            route_for)
    from repro_torch.core.serving import ServingConfig, ServingEngine
    from repro_torch.launch import serve_federated as sf

    with torch.no_grad():  # warm cuBLAS and the allocator on every route
        for vfl, a, b in ((False, 1, 1), (False, 1, 0), (False, 0, 1), (True, 1, 1)):
            x = np.zeros((2, 64, 128), np.float32)
            predict(models, InferenceRequest(x if a else None, x if b else None,
                                             vfl=vfl),
                    ecfg, spec.kind, server_gmv=gmv, codec="int8_topk",
                    device="cuda")
    torch.cuda.synchronize()
    engines = [ServingEngine(models, ecfg, spec.kind, server_gmv=gmv,
                             cfg=ServingConfig(codec="int8_topk",
                                               capacities=(2, 4, 16, 64),
                                               record_wire=record),
                             device="cuda") for record in (False, True)]
    engine = engines[0]
    for mod in launchers.values():
        mod.launches = 0
    rows_by_mix = {mix: sf.serve_mix(engine, spec, mix, requests, rows=64,
                                     seed=seed, salt=MIX_SALT[mix])
                   for mix in MIXES}
    launches = {name: mod.launches for name, mod in launchers.items()}
    st = engine.stats
    for mix, row in rows_by_mix.items():
        print(f"mix {mix:>15}: {row['requests']} req ({row['rows']} rows) "
              f"p50 {row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms "
              f"{row['rps']:.1f} req/s {row['rows_per_s']:.1f} rows/s")
    print(f"engine: {st['batches']} batches {st['batches_by_route']}; "
          f"execute {st['execute_seconds']:.3f} s build {st['build_seconds']:.3f} s "
          f"stall {st['stall_seconds']:.3f} s; launches {launches}")

    analytic = 0
    errs = {"predict": {False: [], True: []}, "cpu": {False: [], True: []}}
    flips = {"predict": [], "cpu": []}  # lossy rows whose messages differ
    worst = {"predict": None, "cpu": None}  # (err, mix, request, row, diff)
    cpu_models = params_from_numpy(params_to_numpy(models), "cpu")
    cpu_gmv = params_from_numpy(params_to_numpy(gmv), "cpu")
    for mix in MIXES:
        reqs = sf.make_requests(spec, mix, requests, rows=64, seed=seed,
                                salt=MIX_SALT[mix])
        results = rows_by_mix[mix]["results"]
        recorded = engines[1].run(reqs)
        check([r.index for r in results] == list(range(len(reqs))),
              f"{mix}: results out of stream order")
        check(all(torch.equal(a.scores, b.scores)
                  for a, b in zip(results, recorded)),
              f"{mix}: a second run of the same stream gave other scores")
        for i, (res, rec, req) in enumerate(zip(results, recorded, reqs)):
            s = res.scores
            check(res.route is route_for(req), f"{mix} {res.index}: route")
            check(tuple(s.shape) == (len(req.x_a if req.x_a is not None
                                         else req.x_b), spec.out_dim),
                  f"{mix} {res.index}: shape {tuple(s.shape)}")
            # dequantised 1.0 may land one ulp above it: q * (s/127)
            check(bool(torch.isfinite(s).all()) and float(s.min()) >= 0.0
                  and float(s.max()) <= 1.0 + EPS32,
                  f"{mix} {res.index}: scores not finite in [0, 1]")
            lossy = res.route is Route.VFL_FALLBACK
            codec = "int8_topk" if lossy else None
            against = {"predict": predict(models, req, ecfg, spec.kind,
                                          server_gmv=gmv, codec=codec,
                                          device="cuda", record_wire=lossy)}
            # the same models on the CPU, where every kernel is its
            # plain version
            against["cpu"] = predict(cpu_models, req, ecfg, spec.kind,
                                     server_gmv=cpu_gmv, codec=codec,
                                     device="cpu", record_wire=lossy)
            for name, want in against.items():
                err = (s.cpu() - want.scores.cpu()).abs().numpy()
                errs[name][lossy].append(err)
                if not lossy:
                    continue
                flips[name].append(sf.message_flips(rec.wire, want.wire))
                row = int(err.max(axis=1).argmax())
                if worst[name] is None or err.max() > worst[name][0]:
                    worst[name] = (float(err.max()), mix, i, row, sf.wire_diff(
                        rec.wire[row], want.wire[row], ecfg.d_hidden))
            if lossy:
                analytic += communication_cost(
                    len(req.x_a), ecfg.d_hidden, "vfl", spec.out_dim,
                    codec="int8_topk")["bytes"]
    tolerance = {}
    for against, by_lossy in errs.items():
        for lossy, e in by_lossy.items():
            cap = (sf.MAX_FLIPPED_RECURRENT if against == "cpu"
                   and ecfg.enc_type == "recurrent" else sf.MAX_FLIPPED)
            tol = sf.within_tolerance(e, lossy, flips[against] if lossy else None,
                                      max_flipped=cap)
            label = f"engine vs {against} ({'int8_topk' if lossy else 'local'} routes)"
            print(f"{label}: max abs err {tol.max_err:.3g}, {tol.within:.5f} of "
                  f"{sum(x.size for x in e)} scores within {sf.ATOL_EXACT}"
                  + (f", {tol.flipped:.5f} of {sum(len(x) for x in e)} rows "
                     f"with differing wire messages (cap {cap})" if lossy else ""))
            if lossy and worst[against] is not None:
                err, mix, i, row, diff = worst[against]
                print(f"    worst row: mix {mix} request {i} row {row}: max abs "
                      f"err {err:.3g}; wire messages "
                      + (f"differ {diff}" if diff else "identical"))
            check(tol.ok, f"{label} beyond tolerance: {tol.why}")
            tolerance[label] = tol._asdict()
    check(analytic == st["wire_bytes"],
          f"measured wire bytes {st['wire_bytes']} != analytic {analytic}")
    print(f"scores finite in [0, 1], routes right; wire bytes {analytic} "
          "== analytic")
    del engines
    return {"engine": engine, "rows_by_mix": rows_by_mix, "launches": launches,
            "batches": dict(st["batches_by_route"]), "tolerance": tolerance}


# ---------------------------------------------- sLSTM and flash attention --

# the CPU tests' shapes (tests/test_kernels.py), the edges of the
# kernel's partition (several row groups with a ragged last one: 20 and
# 5 rows a cluster; H = 1; a last CTA of 31 units), then the recurrent
# encoder's at full width: (B, H, S, hd) with B = 2 and 64 capacity rows
SLSTM_TEST_SHAPES = ((1, 2, 32, 16), (2, 4, 50, 8), (1, 1, 64, 32),
                     (65, 4, 3, 256), (17, 4, 50, 256), (37, 1, 20, 256),
                     (5, 3, 9, 255))
SLSTM_MAIN_SHAPES = ((2, 4, 64, 256), (64, 4, 64, 256))

# (b, hq, hkv, sq, sk, d, causal, window): the CPU tests' cases
# (tests/test_kernels.py), then the transformer encoder's at full width
FLASH_TEST_CASES = (
    (1, 4, 4, 64, 64, 32, True, 0), (2, 8, 2, 128, 128, 64, True, 0),
    (1, 6, 2, 96, 96, 32, True, 0), (2, 4, 1, 64, 192, 32, True, 0),
    (1, 4, 4, 40, 72, 16, True, 0), (1, 4, 2, 128, 128, 32, True, 8),
    (1, 4, 2, 128, 128, 32, True, 32), (1, 4, 2, 128, 128, 32, True, 127),
    (2, 4, 4, 64, 64, 32, False, 0))
# the edges of the kernel's tiling (64 query rows of a K/V group a block,
# 32 keys a tile): Sq not a multiple of 64, Sk not a multiple of 32, d =
# 10 (scalar staging) and 256 with 4 query heads a K/V head in one block,
# causal with Sq > Sk (rows without a key), a window across key tiles
FLASH_EDGE_CASES = (
    (2, 4, 4, 97, 97, 64, False, 0), (1, 4, 1, 33, 77, 10, False, 0),
    (2, 8, 2, 77, 77, 256, False, 0), (1, 4, 1, 16, 16, 10, True, 0),
    (2, 4, 2, 80, 48, 32, True, 0), (1, 4, 2, 100, 130, 16, True, 40),
    (1, 2, 1, 37, 50, 10, False, 5))
FLASH_MAIN = (64, 4, 4, 64, 64, 256, False, 0)
# a long causal GQA case: 8 query heads over 2 K/V heads, 1024 tokens
FLASH_LONG = (1, 8, 2, 1024, 1024, 128, True, 0)
# the language models' shapes (phases 23-25, serve_lm at full width):
# phi4-mini's prefill (8 x 512, 24 query / 8 K/V heads of 128), hymba's
# (2 x 2048, 25 / 5 heads of 64, window 1024), whisper's
# cross-attention (4 decoder tokens over 1500 frames), decode (Sq = 1)
# against 544 keys at query groups of 3 (phi4), 5 (hymba), 6 (qwen2-vl,
# nemotron, dbrx) and 9 (starcoder2), and stablelm's head dim of 80
FLASH_LM_CASES = (
    (8, 24, 8, 512, 512, 128, True, 0), (2, 25, 5, 2048, 2048, 64, True, 1024),
    (2, 16, 16, 4, 1500, 64, False, 0), (8, 24, 8, 1, 544, 128, False, 0),
    (2, 25, 5, 1, 544, 64, False, 0), (2, 12, 2, 1, 544, 128, False, 0),
    (2, 36, 4, 1, 544, 128, False, 0), (2, 32, 32, 128, 128, 80, True, 0))
# the logit cap (attn_logit_softcap; no config sets it): one case
FLASH_SOFTCAP = ((2, 8, 2, 96, 96, 64, True, 0), 5.0)


def slstm_inputs(torch, b, h, s, hd, seed, dtype=None):
    gen = np.random.default_rng(seed)
    pre = torch.from_numpy((gen.standard_normal((b, h, s, 4, hd), np.float32)
                            * 0.5)).cuda()
    r = torch.from_numpy(gen.standard_normal((h, hd, 4 * hd), np.float32)
                         / np.float32(np.sqrt(hd))).cuda()
    return (pre, r) if dtype is None else (pre.to(dtype), r.to(dtype))


def check_slstm(torch, slaunch, sref, pre, r):
    got = slaunch.slstm_cell_cuda(pre, r)
    want = sref.slstm_cell_ref(pre, r)
    torch.cuda.synchronize()
    check(got.dtype == pre.dtype and got.shape == want.shape,
          "slstm output dtype or shape")
    err = (got.float() - want.float()).abs()
    check(bool((err <= sref.slstm_error_bound(want, got)).all()),
          f"slstm beyond its bound: max err {float(err.max())}")
    return float(err.max())


def slstm_bound_ms(b, h, s, hd, itemsize, mem_rate):
    """The larger of: pre_x read once, r read once (f32), h written once,
    over the memory rate; and the recurrent products' 2*hd*4hd f32
    operations a step and (b, h) pair over the f32 peak (the gate math,
    under 1% more, is left out, so the bound stays a lower bound)."""
    nbytes = b * h * s * 5 * hd * itemsize + h * hd * 4 * hd * 4
    ops = b * h * s * 2 * hd * 4 * hd
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_slstm(torch, slaunch, sref, shape, mem_rate, plain=True):
    b, h, s, hd = shape
    nxt = rotation(lambda: slstm_inputs(torch, b, h, s, hd, seed=b),
                   b * h * s * 4 * hd * 4)
    ms = cuda_time_ms(lambda: slaunch.slstm_cell_cuda(*nxt()), iters=50, warmup=3)
    out = {"shape": list(shape), "ms": ms,
           "device_ms": device_ms(lambda: slaunch.slstm_cell_cuda(*nxt()), iters=20,
                                  label=f"slstm {shape}")}
    if plain:
        out["plain_ms"] = cuda_time_ms(lambda: sref.slstm_cell_ref(*nxt()),
                                       iters=5, warmup=1)
        out["plain_device_ms"] = device_ms(lambda: sref.slstm_cell_ref(*nxt()),
                                           iters=3, label=f"slstm plain {shape}")
    out["bound_ms"], out["bound_by"] = slstm_bound_ms(b, h, s, hd, 4, mem_rate)
    return out


def flash_inputs(torch, b, hq, hkv, sq, sk, d, seed, dtype=None):
    gen = np.random.default_rng(seed)
    out = [torch.from_numpy(gen.standard_normal(shape, np.float32)).cuda()
           for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return out if dtype is None else [x.to(dtype) for x in out]


def check_flash(torch, flaunch, fref, q, k, v, causal, window):
    got = flaunch.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          "flash output dtype or shape")
    tol = fref.TOL[q.dtype]
    err = (got.float() - want.float()).abs()
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"flash beyond {tol}: max err {float(err.max())}")
    return float(err.max()), got


def visible_mask(sq, sk, causal, window):
    """(Sq, Sk) bool: the keys each query sees, queries end-aligned."""
    qi = np.arange(sq)[:, None] + (sk - sq)
    ki = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask = ki <= qi
    if window > 0:
        mask &= ki > qi - window
    return mask


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs of one head that the masks let through
    (``visible_mask``'s count, a query at a time)."""
    qi = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qi, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def time_flash(torch, flaunch, fref, case, mem_rate, dtype=None, plain=True):
    """The flash kernel at ``case`` in ``dtype`` (f32 if None), beside
    scaled_dot_product_attention on the same inputs and, if ``plain``,
    the plain version: per-call CUDA-event times (the headline),
    profiler device times, and the bound."""
    b, hq, hkv, sq, sk, d, causal, window = case
    F = torch.nn.functional
    dtype = dtype or torch.float32
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * itemsize
    nxt = rotation(lambda: flash_inputs(torch, b, hq, hkv, sq, sk, d, seed=d,
                                        dtype=dtype), nbytes)
    tag = f"{case[:6]} {str(dtype)[6:]}"

    def kern():
        return flaunch.flash_attention_cuda(*nxt(), causal=causal, window=window)

    def plain_fn():
        return fref.flash_attention_ref(*nxt(), causal=causal, window=window)

    check(not causal or sq == sk,
          "SDPA's causal mask is end-aligned only when Sq == Sk")
    # a window goes to SDPA as a boolean mask of the visible keys
    mask = (torch.from_numpy(visible_mask(sq, sk, causal, window)).cuda()
            if window > 0 else None)

    def sdpa():  # the library yardstick: timed here, never on the path
        return F.scaled_dot_product_attention(
            *nxt(), attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=hq != hkv)

    out = {"shape": [b, hq, hkv, sq, sk, d], "causal": causal, "window": window,
           "dtype": str(dtype)[6:], "ms": cuda_time_ms(kern),
           "library_ms": cuda_time_ms(sdpa),
           "device_ms": device_ms(kern, label=f"flash {tag}"),
           "library_device_ms": device_ms(sdpa, label=f"SDPA {tag}")}
    if plain:
        out["plain_ms"] = cuda_time_ms(plain_fn, iters=50)
        out["plain_device_ms"] = device_ms(plain_fn, label=f"flash plain {tag}")
    # bound: q, k, v read once and the output written once, over the
    # memory rate; 4*d operations (q.k and p*v) for each visible (query,
    # key) pair, on the engine the kernel runs them on: f32 in 3xTF32 on
    # the tensor cores (three TF32 products for each f32 one, 495 / 3
    # TFLOP/s), bf16 on them at its own rate
    bytes_ms = nbytes / mem_rate * 1e3
    ops = 4 * d * visible_pairs(sq, sk, causal, window) * b * hq
    peak = TF32_OPS_PER_S / 3 if dtype == torch.float32 else BF16_OPS_PER_S
    ops_ms = ops / peak * 1e3
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    out["vs_library"] = out["ms"] / out["library_ms"]
    out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


def slstm_phase(torch, slaunch, sref, mem_rate):
    """Phase 9: the kernel's partition (the built kernel's plan equal to
    ``slstm_cell.plan`` with the card's cluster budget, its clusters in
    one wave where the heads and the 32-row cap allow, at every shape of
    phases 9 and 14), then the sLSTM kernel against its
    plain version (the CPU tests' shapes, the partition's edges and full
    width, f32 and bf16), then timed at the serving capacities. Returns
    (max abs err by dtype, timings)."""
    for b, h, s, hd in SLSTM_TEST_SHAPES + SLSTM_MAIN_SHAPES + SLSTM_STATE_SHAPES:
        got, budget, active = slaunch.kernel_plan(b, h, hd)
        want = slaunch.plan(b, h, hd, budget)
        one_wave = h * got.groups <= max(budget, h) or got.rows == slaunch.MAX_ROWS
        check(got == want and active >= 1 and one_wave,
              f"slstm plan at {(b, h, s, hd)}: the kernel's {got} (budget "
              f"{budget}, the card holds {active}) against {want}")
    for b, h, s, hd in SLSTM_MAIN_SHAPES + SLSTM_STATE_SHAPES[:1]:
        p, budget, active = slaunch.kernel_plan(b, h, hd)
        print(f"slstm_cell plan at {(b, h, s, hd)}: {h * p.groups} clusters of "
              f"{p.cluster} CTAs ({p.cluster * h * p.groups} CTAs; the card "
              f"holds {active} such clusters at once, budget {budget}), "
              f"{p.units} units and {p.rows} rows a CTA, {p.rows_per_thread} "
              f"rows and {p.gates_per_thread} gates a thread, {p.threads} "
              f"computing threads, {p.smem} bytes of shared memory")
    slstm_err, n_cases = {}, 0
    for shape in SLSTM_TEST_SHAPES + SLSTM_MAIN_SHAPES:
        pre, r = slstm_inputs(torch, *shape, seed=sum(shape))
        err = check_slstm(torch, slaunch, sref, pre, r)
        slstm_err["float32"] = max(slstm_err.get("float32", 0.0), err)
        n_cases += 1
        if shape in SLSTM_MAIN_SHAPES:  # the recurrent encoder's shapes
            print(f"slstm_cell {shape} f32: h max abs err {err:.3g} against "
                  "the plain version")
    for shape in SLSTM_MAIN_SHAPES + ((17, 4, 50, 256),):
        pre, r = slstm_inputs(torch, *shape, seed=1, dtype=torch.bfloat16)
        slstm_err["bfloat16"] = max(slstm_err.get("bfloat16", 0.0),
                                    check_slstm(torch, slaunch, sref, pre, r))
        n_cases += 1
    del pre, r
    print(f"{n_cases} cases within slstm_error_bound of the plain version; "
          f"max abs err {slstm_err}")
    slstm_times = [time_slstm(torch, slaunch, sref, (b, 4, 64, 256), mem_rate,
                              plain=b == 64) for b in (2, 4, 16, 64)]
    for t in slstm_times:
        print(f"slstm_cell {t['shape']}: kernel {t['ms']:.5f} ms (device "
              f"{t['device_ms']} ms), plain {t.get('plain_ms', float('nan')):.5f} "
              f"ms (device {t.get('plain_device_ms')} ms); bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    return slstm_err, slstm_times


def flash_phase(torch, flaunch, fref, mem_rate):
    """Phase 10: the flash kernel against its plain version (every mask
    and shape of the CPU tests, the tiling's edges, full width, the long
    causal GQA case, the language models' shapes, f32 and bf16, rows
    without a visible key, a logit cap), then timed at full width (f32,
    with the plain version; bf16), at the long causal GQA case (f32,
    bf16) and at each language model's shape (f32; phi4-mini's prefill
    with the plain version), each beside scaled_dot_product_attention.
    Returns (max abs err by dtype, the timings, the f32 full-width one
    first)."""
    flash_err, n_cases = {}, 0
    for case in (FLASH_TEST_CASES + FLASH_EDGE_CASES + (FLASH_MAIN, FLASH_LONG)
                 + FLASH_LM_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, *case[:6], seed=sum(case[:6]), dtype=dtype)
            err, got = check_flash(torch, flaunch, fref, q, k, v, *case[6:])
            b, hq, hkv, sq, sk = case[:5]
            if case[6] and sq > sk:  # causal: the first sq - sk rows see no key
                check(bool((got[:, :, :sq - sk] == 0).all()),
                      f"flash {case}: rows without a visible key are not 0")
            key = str(dtype).replace("torch.", "")
            flash_err[key] = max(flash_err.get(key, 0.0), err)
            n_cases += 1
    case, cap = FLASH_SOFTCAP
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(torch, *case[:6], seed=7, dtype=dtype)
        q = q * 3  # scores of several units, so that the cap bends them
        got = flaunch.flash_attention_cuda(q, k, v, causal=case[6], window=0,
                                           softcap=cap)
        want = fref.flash_attention_ref(q, k, v, causal=case[6], softcap=cap)
        torch.cuda.synchronize()
        tol = fref.TOL[dtype]
        err = (got.float() - want.float()).abs()
        check(bool((err <= tol + tol * want.float().abs()).all()),
              f"flash with softcap {cap} beyond {tol}: max err {float(err.max())}")
        key = "softcap_" + str(dtype).replace("torch.", "")
        flash_err[key] = float(err.max())
        n_cases += 1
    del q, k, v, got
    print(f"{n_cases} cases within tolerance of the plain version (f32 2e-5, "
          f"bf16 2e-2), finite, rows without keys exactly 0; the language "
          f"models' shapes included; max abs err {flash_err}")
    times = [time_flash(torch, flaunch, fref, FLASH_MAIN, mem_rate),
             time_flash(torch, flaunch, fref, FLASH_MAIN, mem_rate,
                        dtype=torch.bfloat16, plain=False),
             time_flash(torch, flaunch, fref, FLASH_LONG, mem_rate, plain=False),
             time_flash(torch, flaunch, fref, FLASH_LONG, mem_rate,
                        dtype=torch.bfloat16, plain=False)]
    times += [time_flash(torch, flaunch, fref, case, mem_rate, plain=i == 0)
              for i, case in enumerate(FLASH_LM_CASES)]
    for t in times:
        plain = (f", plain {t['plain_ms']:.5f} ms (device {t['plain_device_ms']} ms)"
                 if "plain_ms" in t else "")
        print(f"flash_attention {t['shape']} causal={t['causal']} window="
              f"{t['window']} {t['dtype']}: "
              f"kernel {t['ms']:.5f} ms (device {t['device_ms']} ms){plain}, SDPA "
              f"{t['library_ms']:.5f} ms (device {t['library_device_ms']} ms); "
              f"kernel / SDPA {t['vs_library']:.3f}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {t['bound_share']:.3f} of it")
    return flash_err, times


def recurrent_layers(torch, spec, ecfg, models, seed=0, requests=64) -> dict:
    """Fault (g), layer by layer: the recurrent encoder's card-vs-CPU max
    abs difference on the VFL requests of phase 11's fixed streams (every
    row, both modalities), at its input layer tanh(x @ w_in + b), the
    sLSTM's input projection pre_x = h @ wx + b, the sLSTM h sequence,
    the encoder's output feature, and the sLSTM kernel alone (the card's
    kernel against the plain version on the CPU's pre_x). The layers
    repeat ``encoder_apply``'s recurrent branch, held equal to it."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.encoders import encoder_apply
    from repro_torch.kernels.slstm_cell.ops import slstm_cell
    from repro_torch.launch import serve_federated as sf
    from repro_torch.models.common import dense, rmsnorm

    nh = ecfg.n_heads
    cpu_models = params_from_numpy(params_to_numpy(models), "cpu")

    def layers(p, x, r=None):
        inp = torch.tanh(dense(p["in"], x))
        b, s, d = inp.shape
        cell = p["cell"]
        pre = (inp @ cell["wx"] + cell["b"]).float()  # as slstm_scan forms it
        pre = pre.reshape(b, s, 4, nh, d // nh).permute(0, 3, 1, 2, 4).contiguous()
        hs = slstm_cell(pre, cell["r"].float() if r is None else r)
        feat = rmsnorm(p["norm"], hs.permute(0, 2, 1, 3).reshape(b, s, d)[:, -1])
        return {"input layer": inp, "pre_x": pre, "sLSTM h": hs, "feature": feat}

    worst = {}
    with torch.no_grad():
        for mix in MIXES:
            for req in sf.make_requests(spec, mix, requests, rows=64, seed=seed,
                                        salt=MIX_SALT[mix]):
                if not req.vfl:
                    continue
                for name, x in (("f_A", req.x_a), ("f_B", req.x_b)):
                    xc = torch.from_numpy(np.ascontiguousarray(x))
                    card = layers(models[name], xc.cuda())
                    cpu = layers(cpu_models[name], xc)
                    check(torch.equal(card["feature"],
                                      encoder_apply(models[name], xc.cuda(), ecfg)),
                          "the layer breakdown does not repeat encoder_apply")
                    alone = slstm_cell(cpu["pre_x"].cuda(),
                                       cpu_models[name]["cell"]["r"].float().cuda())
                    diffs = {k: float((card[k].cpu() - cpu[k]).abs().max())
                             for k in cpu}
                    diffs["sLSTM kernel alone"] = float(
                        (alone.cpu() - cpu["sLSTM h"]).abs().max())
                    for k, v in diffs.items():
                        worst[k] = max(worst.get(k, 0.0), v)
    return worst


# Phase 11's requests a mix, by encoder. Each request is checked against
# the same models on the CPU, where the recurrent encoder costs about
# 3.5 times the transformer a row (phase 11 took 138-235 s of the run at
# 64 requests a mix, 75 s at 32), so it serves 16 (32 requests: 3267
# rows, 449 of them VFL rows; 6191 and 1237 at 64).
VARIANT_REQUESTS = {"recurrent": 16, "transformer": 64}


def variant_serving(torch, spec, enc, sf, counted) -> dict:
    """Phase 11: full-width serving (phase 4's set-up and checks) with
    the recurrent, then the transformer encoders, VARIANT_REQUESTS
    requests a mix; each encoder kernel launches once per encoder
    application and the other not at all."""
    variants = {}
    for enc_type, own, symbol in (("recurrent", "slstm_cell", "slstm_kernel"),
                                  ("transformer", "flash_attention", "flash_kernel")):
        vcfg = enc.EncoderConfig(d_hidden=1024, n_layers=4, enc_type=enc_type,
                                 n_heads=4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        vmodels = enc.init_client_models(gen, spec, vcfg, device="cuda")
        vgmv = enc.fusion_init(gen, vcfg.d_hidden, spec.out_dim, device="cuda")
        n_req = VARIANT_REQUESTS[enc_type]
        print(f"-- {enc_type}: d_hidden 1024, 4 heads of 256, {n_req} requests "
              "a mix")
        res = full_width_serving(torch, spec, vcfg, vmodels, vgmv, counted,
                                 requests=n_req)
        bt, got = res["batches"], res["launches"]
        applies = (2 * (bt["multimodal"] + bt["vfl_fallback"])
                   + bt["unimodal_A"] + bt["unimodal_B"])
        print(f"{own} launches {got[own]} == {applies} encoder applications "
              f"({bt})")
        check(got[own] == applies, f"{own} launches {got[own]} != {applies} "
              "encoder applications")
        check(all(n == 0 for name, n in got.items()
                  if name not in (own, "wire_codec")),
              f"{enc_type} serving launched another kernel: {got}")
        check(got["wire_codec"] == 3 * bt["vfl_fallback"],
              f"wire_codec launches {got['wire_codec']}")
        if enc_type == "recurrent":  # fault (g): where card and CPU part
            layers = recurrent_layers(torch, spec, vcfg, vmodels, requests=n_req)
            flipped = res["tolerance"]["engine vs cpu (int8_topk routes)"]["flipped"]
            print("recurrent encoder card vs CPU, max abs difference by layer "
                  "(VFL rows of the fixed streams): " + ", ".join(
                      f"{k} {v:.3g}" for k, v in layers.items())
                  + f"; rows with differing wire messages {flipped:.5f}")
            res["layers_card_vs_cpu"] = layers
        engine = res.pop("engine")
        bd = device_breakdown(
            lambda: sf.serve_mix(engine, spec, "all_multimodal", n_req, rows=64,
                                 seed=0, salt=MIX_SALT["all_multimodal"]),
            res["rows_by_mix"]["all_multimodal"]["wall_s"], match=(symbol,))
        print_breakdown(f"{enc_type} all_multimodal", bd)
        print(f"    {own}: {bd['matched'][symbol]['ms']:.3f} ms in "
              f"{bd['matched'][symbol]['calls']} launches")
        variants[enc_type] = {"launches": got[own], "breakdown": bd,
                              "layers_card_vs_cpu": res.get("layers_card_vs_cpu")}
        del engine, vmodels, vgmv, res
        torch.cuda.empty_cache()
    return variants


def variant_cli(sf, slaunch, flaunch, sbwd, fbwd):
    """Phase 12: the CLI selftest on seeded recurrent and transformer
    models, then on models it trains inline (2 rounds, 3 clients; their
    gradients through the backward kernels), on the card."""
    for enc_type, mod, bwd in (("recurrent", slaunch, sbwd),
                               ("transformer", flaunch, fbwd)):
        mod.launches = bwd.launches = 0
        sf.main(["--selftest", "--enc-type", enc_type, "--train-rounds", "0",
                 "--codec", "int8_topk", "--device", "cuda"])
        check(mod.launches > 0 and bwd.launches == 0,
              f"CLI selftest ({enc_type}): {mod.launches} forward, "
              f"{bwd.launches} backward launches")
        print(f"CLI selftest ({enc_type}): {mod.launches} launches")
        mod.launches = 0
        sf.main(["--selftest", "--enc-type", enc_type, "--train-rounds", "2",
                 "--device", "cuda"])
        check(mod.launches > 0 and bwd.launches > 0,
              f"CLI selftest ({enc_type}, trained inline): {mod.launches} "
              f"forward, {bwd.launches} backward launches")
        print(f"CLI selftest ({enc_type}, 2 rounds trained inline): "
              f"{mod.launches} forward, {bwd.launches} backward launches")


# ------------------------------------------------- mLSTM and xlstm-350m --

# (b, h, s, dk, dv, chunk): the CPU tests' shapes (tests/test_kernels.py),
# a ragged S at the model's chunk, then xlstm-350m's mLSTM at full width
# (8 sequences of 512 tokens, 4 heads of dk = dv = 512, chunk 64)
MLSTM_TEST_CASES = ((1, 2, 64, 16, 16, 16), (2, 3, 100, 32, 16, 32),
                    (1, 1, 128, 64, 64, 128), (2, 4, 77, 512, 512, 64))
MLSTM_MAIN = (8, 4, 512, 512, 512, 64)
# hymba's Mamba heads (phase 25): 2 x 2048 tokens, 25 heads, dk = ssm_state
# 16 (padded to 32 by the kernel's plan), dv = 64, normalize off
MLSTM_HYMBA = (2, 25, 2048, 16, 64, 64)
# the stateful sLSTM at xlstm-350m's width: prefill of 512 tokens, and a
# decode step (S = 1), each from a running (non-zero) state (these two
# are timed); then the partition's edges from a state: hd = 100 (4 CTAs
# of 25 units) and a decode step at 10 rows (3 rows a cluster)
SLSTM_STATE_SHAPES = ((8, 4, 512, 256), (8, 4, 1, 256), (3, 2, 17, 100),
                      (10, 4, 1, 256))
# xlstm-350m serving: 8 prompts of 512 tokens, 32 greedy decode steps
LM_BATCH, LM_PROMPT, LM_GEN = 8, 512, 32
# card against CPU at full width: 2 prompts of 128 tokens, then 4
# decode steps fed the card's greedy tokens. Logits and caches within
# atol = rtol = LM_CPU_TOL: f32 sums in other orders (cuBLAS against the
# CPU's GEMMs at K = 1024-2048, the kernels' chunkwise and in-block sums
# against the plain step recurrences), carried through 24 layers.
LM_CPU_TOL = 2e-3
# prefill against forward on the card, and a decode step after prefill
# against forward on the extended sequence: the reference test's
# tolerances (tests/test_arch_smoke.py)
LM_PREFILL_TOL, LM_DECODE_TOL = 2e-4, 5e-4


def mlstm_inputs(torch, b, h, s, dk, dv, seed):
    """The reference kernel test's distributions, on the card."""
    gen = np.random.default_rng(seed)
    q = gen.standard_normal((b, h, s, dk), np.float32)
    k = gen.standard_normal((b, h, s, dk), np.float32) * np.float32(0.5)
    v = gen.standard_normal((b, h, s, dv), np.float32)
    lf = -np.abs(gen.standard_normal((b, h, s), np.float32)) * np.float32(0.2)
    return [torch.from_numpy(x).cuda() for x in (q, k, v, lf)]


def check_mlstm(torch, mlaunch, mref, q, k, v, lf, chunk, normalize):
    """h, final C and n of the kernel against the plain version, each
    within mlstm_error_bound; returns their max abs errors."""
    got, (c, n) = mlaunch.mlstm_scan_cuda(q, k, v, lf, chunk=chunk,
                                          normalize=normalize, return_state=True)
    want, (wc, wn) = mref.mlstm_scan_ref(q, k, v, lf, normalize=normalize,
                                         return_state=True)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in (("h", got, want), ("C", c, wc), ("n", n, wn)):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"mlstm {name}: shape or non-finite values")
        e = (g - w).abs()
        check(bool((e <= mref.mlstm_error_bound(w)).all()),
              f"mlstm {name} beyond its bound: max err {float(e.max())}")
        errs[name] = float(e.max())
    return errs


def mlstm_flops(b, h, s, dk, dv, chunk):
    """FLOPs of the chunkwise form on these shapes: per (b, h) and chunk
    of L steps, the causal scores (dk L(L+1)) and in-chunk sums
    (dv L(L+1)), q.C (2 L dk dv) and the state update (2 L dk dv)."""
    nc = -(-s // chunk)
    per = chunk * (chunk + 1) * (dk + dv) + 4 * chunk * dk * dv
    return b * h * nc * per


def mlstm_phase(torch, mlaunch, mref, mem_rate, ptxas):
    """Phase 13: the kernel's plan at full width (cluster size, waves,
    shared memory; the built kernel's equal to ``mlstm_scan.plan`` with
    the card's cluster capacities) and its registers, then the mLSTM
    kernel against its plain version (the CPU tests' shapes, a ragged S,
    full width, hymba's Mamba heads; normalize on and off; h, C and n),
    then timed at full width and at hymba's shape (``time_mlstm``).
    Returns (max abs err, errors at full width, timing with the hymba
    one under "hymba")."""
    b, h, s, dk, dv, chunk = MLSTM_MAIN
    plan, active = mlaunch.kernel_plan(b * h, dk, dv, chunk)
    check(plan == mlaunch.plan(b * h, dk, dv, chunk, active)
          and plan.waves <= mlaunch.plan(b * h, dk, dv, chunk, active, cluster=1).waves,
          f"mlstm plan at {MLSTM_MAIN}: the kernel's {plan} against "
          f"{mlaunch.plan(b * h, dk, dv, chunk, active)}")
    inst = f"ILi{chunk}ELi{plan.tk}ELi{mlaunch.score_slots(chunk, plan.cluster)}E"
    regs = [info for name, info in ptxas if "mlstm_kernel" in name and inst in name]
    print(f"mlstm_scan plan at {MLSTM_MAIN[:5]} chunk {chunk}: {plan.clusters} "
          f"clusters of {plan.cluster} CTAs ({plan.ctas} CTAs, {plan.waves} waves; "
          f"the card holds {active} clusters of each size at once), TK "
          f"{plan.tk}, {plan.smem} bytes of shared memory; ptxas {regs}")
    worst, n_cases = 0.0, 0
    for case in MLSTM_TEST_CASES + (MLSTM_MAIN, MLSTM_HYMBA):
        for normalize in (True, False):
            q, k, v, lf = mlstm_inputs(torch, *case[:5], seed=sum(case))
            errs = check_mlstm(torch, mlaunch, mref, q, k, v, lf, case[5], normalize)
            worst = max(worst, *errs.values())
            n_cases += 1
            if case == MLSTM_MAIN and normalize:
                main_errs = errs
    del q, k, v, lf
    print(f"{n_cases} cases (h, final C and n) within mlstm_error_bound of the "
          f"plain version; max abs err {worst:.3g}; at {MLSTM_MAIN[:5]}: "
          f"{main_errs}")
    t = time_mlstm(torch, mlaunch, mref, MLSTM_MAIN, True, mem_rate)
    t.update(engine="tensor cores: mma.sync m16n8k8 TF32, 3xTF32 split",
             plan=vars(plan), active_clusters=active, ptxas=regs)
    t["hymba"] = time_mlstm(torch, mlaunch, mref, MLSTM_HYMBA, False, mem_rate)
    t["hymba"]["plan"] = vars(mlaunch.kernel_plan(
        MLSTM_HYMBA[0] * MLSTM_HYMBA[1], *MLSTM_HYMBA[3:])[0])
    return worst, main_errs, t


def time_mlstm(torch, mlaunch, mref, case, normalize, mem_rate) -> dict:
    """The mLSTM kernel at ``case`` beside the plain version and the
    bound at both f32-accurate rates: three TF32 products for each f32
    one on the tensor cores (495 TFLOP/s), as the kernel runs them, which
    is the lower and so the bound (``bound_ms``), and f32 on SIMT (67
    TFLOP/s, ``bound_ms_simt``)."""
    b, h, s, dk, dv, chunk = case
    nbytes = 4 * b * h * (s * (2 * dk + 2 * dv + 1) + dk * dv + dk)
    nxt = rotation(lambda: mlstm_inputs(torch, b, h, s, dk, dv, seed=1), nbytes)

    def kern():
        return mlaunch.mlstm_scan_cuda(*nxt(), chunk=chunk, normalize=normalize,
                                       return_state=True)

    def plain():
        return mref.mlstm_scan_ref(*nxt(), normalize=normalize, return_state=True)

    flops = mlstm_flops(b, h, s, dk, dv, chunk)
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = min(3 * flops / TF32_OPS_PER_S, flops / FP32_OPS_PER_S) * 1e3
    tag = f"{case[:5]}"
    t = {"shape": list(case[:5]), "chunk": chunk, "normalize": normalize,
         "ms": cuda_time_ms(kern, iters=20, warmup=3),
         "device_ms": device_ms(kern, iters=10, label=f"mlstm {tag}"),
         "plain_ms": cuda_time_ms(plain, iters=3, warmup=1),
         "plain_device_ms": device_ms(plain, iters=1, label=f"mlstm plain {tag}"),
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "bound_ms_simt": max(bytes_ms, flops / FP32_OPS_PER_S * 1e3),
         "gflop": flops / 1e9}
    print(f"mlstm_scan {t['shape']} chunk {chunk} normalize={normalize}: kernel "
          f"{t['ms']:.5f} ms (device {t['device_ms']} ms), plain "
          f"{t['plain_ms']:.5f} ms (device {t['plain_device_ms']} ms); bound "
          f"{t['bound_ms']:.6f} ms in 3xTF32 on the tensor cores "
          f"({t['bound_by']}, {t['gflop']:.2f} GFLOP), {t['bound_ms_simt']:.6f} "
          f"ms in f32 on SIMT; kernel at {t['bound_ms'] / t['ms']:.3f} / "
          f"{t['bound_ms_simt'] / t['ms']:.3f} of them")
    return t


def running_state(torch, b, h, hd, seed):
    """A non-zero sLSTM (c, n, m, h), as a running sequence leaves it."""
    gen = np.random.default_rng(seed)
    c, n, m, hp = (gen.standard_normal((b, h, hd), np.float32) for _ in range(4))
    return tuple(torch.from_numpy(x).cuda() for x in
                 (c, np.abs(n) + 1, m * np.float32(0.5), np.tanh(hp)))


def slstm_state_phase(torch, slaunch, sref, mem_rate):
    """Phase 14: the sLSTM kernel from a running state (prefill length,
    a decode step, the partition's edges) against its plain version,
    output and final state within slstm_error_bound; then xlstm-350m's
    two shapes timed. Returns (max abs err, timings)."""
    worst, times = 0.0, []
    for b, h, s, hd in SLSTM_STATE_SHAPES:
        pre, r = slstm_inputs(torch, b, h, s, hd, seed=s)
        st = running_state(torch, b, h, hd, seed=hd + s)
        got, fin = slaunch.slstm_cell_cuda(pre, r, initial_state=st,
                                           return_state=True)
        want, wfin = sref.slstm_cell_ref(pre, r, st, return_state=True)
        torch.cuda.synchronize()
        for g, w in ((got, want), *zip(fin, wfin)):
            e = (g - w).abs()
            check(bool((e <= sref.slstm_error_bound(w, g)).all()),
                  f"stateful slstm {(b, h, s, hd)} beyond its bound: {float(e.max())}")
            worst = max(worst, float(e.max()))
        if (b, h, hd) != (LM_BATCH, 4, 256):
            continue
        nxt = rotation(lambda: (*slstm_inputs(torch, b, h, s, hd, seed=b),
                                running_state(torch, b, h, hd, seed=1)),
                       b * h * s * 4 * hd * 4 + 4 * b * h * hd * 4)

        def kern():
            pre_, r_, st_ = nxt()
            return slaunch.slstm_cell_cuda(pre_, r_, initial_state=st_,
                                           return_state=True)

        def plain():
            pre_, r_, st_ = nxt()
            return sref.slstm_cell_ref(pre_, r_, st_, return_state=True)

        t = {"shape": [b, h, s, hd], "state": True,
             "ms": cuda_time_ms(kern, iters=20, warmup=3),
             "device_ms": device_ms(kern, iters=10, label=f"slstm state {s}"),
             "plain_ms": cuda_time_ms(plain, iters=3, warmup=1),
             "plain_device_ms": device_ms(plain, iters=2,
                                          label=f"slstm state plain {s}")}
        t["bound_ms"], t["bound_by"] = slstm_bound_ms(b, h, s, hd, 4, mem_rate)
        times.append(t)
        print(f"slstm_cell with a state {t['shape']}: kernel {t['ms']:.5f} ms "
              f"(device {t['device_ms']} ms), plain {t['plain_ms']:.5f} ms "
              f"(device {t['plain_device_ms']} ms); bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")
    print(f"{len(SLSTM_STATE_SHAPES)} cases from a running state: output and "
          f"final (c, n, m, h) within slstm_error_bound; max abs err {worst:.3g}")
    return worst, times


# Phases 23-25: every language-model family through serve_lm at full
# width. phi4-mini-3.8b at full depth (32 layers): 8 prompts of 512
# tokens, 32 greedy decode steps.
PHI4_BATCH, PHI4_PROMPT, PHI4_GEN = 8, 512, 32
# The other families (phase 25), each at full width: its depth on the
# card (None: all of it; deepseek-moe-16b's 28 layers are 67.5 GB in f32,
# dbrx-132b's 131.6 B parameters fit no card, and nemotron-4-15b's 62.5
# GB leave no room for init's stacking copy), batch, prompt tokens (and
# vision patches or audio frames), decode steps, and the cut depth and
# sizes of its card-vs-CPU run (None: none here; nemotron's and dbrx's
# full-width copies on the CPU took 19 s, and phase 33 holds every
# family's bf16 card against CPU).
FAMILY_RUNS = (
    dict(name="qwen2_vl_2b", layers=None, batch=2, prompt=128, patches=1024,
         gen=8, cpu=dict(layers=2, batch=2, prompt=64, patches=256, gen=2)),
    dict(name="hymba_1p5b", layers=None, batch=2, prompt=2048, gen=8,
         cpu=dict(layers=2, batch=2, prompt=128, gen=2)),
    dict(name="whisper_medium", layers=None, batch=2, prompt=4, frames=1500,
         gen=8, cpu=dict(layers=2, batch=2, prompt=4, frames=500, gen=2)),
    dict(name="deepseek_moe_16b", layers=4, batch=4, prompt=512, gen=8,
         cpu=dict(layers=2, batch=2, prompt=32, gen=2)),
    dict(name="starcoder2_7b", layers=2, batch=2, prompt=128, gen=2,
         cpu=dict(layers=2, batch=2, prompt=32, gen=2)),
    dict(name="nemotron_4_15b", layers=2, batch=2, prompt=128, gen=2, cpu=None),
    dict(name="stablelm_3b", layers=2, batch=2, prompt=128, gen=2,
         cpu=dict(layers=2, batch=2, prompt=32, gen=2)),
    dict(name="dbrx_132b", layers=2, batch=2, prompt=128, gen=2, cpu=None),
)
# MoE card vs CPU: every router call's expert choices equal on both; the
# CPU run's smallest gap between a token's k-th and (k+1)-th expert
# probability must be at least this (a smaller gap could let the two
# devices' last-ulp differences pick other experts): the prompt's seed is
# the first of MOE_SEEDS whose CPU run keeps it.
MOE_GAP, MOE_SEEDS = 1e-5, 8
# A sliding-window model's decode step against forward past its ring's
# wrap (phase 25): prompts of window - 24 (no wrap), 2 x window (a wrap
# at a multiple of the ring) and 2 x window + 300 (a wrap that leaves the
# ring's oldest entry mid-buffer), each from these prompt seeds.
RING_PROBE_OFFSETS, RING_PROBE_SEEDS = ((1, -24), (2, 0), (2, 300)), (0, 1, 2)
# the kernels a language model's serving launches, by symbol
LM_KERNELS = ("flash_kernel", "mlstm_kernel", "slstm_kernel")


def cut_cfg(cfg, layers):
    """``cfg`` at its first ``layers`` layers (every stack of an
    encoder-decoder); None keeps its depth."""
    if layers is None:
        return cfg
    return (cfg.replace(n_layers=layers, n_enc_layers=layers) if cfg.is_encdec
            else cfg.replace(n_layers=layers))


def cut_depth(params, cfg, layers):
    """The first ``layers`` layers of a model, as views, and its config at
    that depth (``cut_cfg``)."""
    from repro_torch.common.tree import tree_map

    if layers is None:
        return params, cfg
    cut = lambda x: x[:layers]  # noqa: E731
    stacks = ("enc_layers", "dec_layers") if cfg.is_encdec else ("layers",)
    return (dict(params, **{k: tree_map(cut, params[k]) for k in stacks}),
            cut_cfg(cfg, layers))


def lm_inputs(torch, cfg, batch, prompt, patches=0, frames=0, seed=0,
              device="cuda"):
    """(tokens (B, prompt) int32, {patches or frames}) from a seed, on
    ``device``; the sequence prefill sees is patches + prompt long."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))
                              .astype(np.int32)).to(device)
    inputs = {}
    if patches:
        inputs["patches"] = rng.standard_normal((batch, patches, cfg.frontend_dim),
                                                np.float32)
    if frames:
        inputs["frames"] = rng.standard_normal((batch, frames, cfg.frontend_dim),
                                               np.float32)
    return tokens, {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}


def expected_launches(cfg) -> tuple:
    """{kernel: launches} a prefill and a decode step of ``cfg``, nothing
    else: one flash launch an attention (an encoder-decoder's decoder has
    two, self and cross); one mLSTM scan a hybrid layer's prefill; an
    xLSTM pair one mLSTM scan and one sLSTM cell a prefill, one sLSTM cell
    a step."""
    if cfg.block_type == "xlstm_pair":
        n = cfg.n_layers // 2
        return ({"mlstm_scan": n, "slstm_cell": n}, {"slstm_cell": n})
    if cfg.is_encdec:
        flash = (cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers)
    else:
        flash = (cfg.n_layers, cfg.n_layers)
    mlstm = (cfg.n_layers, 0) if cfg.block_type == "hybrid" else (0, 0)
    return ({"flash_attention": flash[0], "mlstm_scan": mlstm[0]},
            {"flash_attention": flash[1], "mlstm_scan": mlstm[1]})


def decode_gap(torch, bb, params, cfg, batch_in, cache, idx, nt) -> float:
    """Max abs difference between a decode step fed ``nt`` after the
    prefill that gave (``cache``, ``idx``) and forward's last logits on
    the extended sequence; checked within LM_DECODE_TOL."""
    # the step writes into the cache it is given: a clone keeps ``cache``
    lg, _ = bb.decode_step(params, cfg, nt, bb.clone_cache(cache), idx)
    ext = dict(batch_in, tokens=torch.cat([batch_in["tokens"], nt], 1))
    full, _ = bb.forward(params, cfg, ext)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    check(torch.allclose(lg[:, 0], full[:, -1], atol=LM_DECODE_TOL,
                         rtol=LM_DECODE_TOL),
          f"{cfg.name} decode step vs forward at {ext['tokens'].shape[1]} "
          f"tokens: {err}")
    return err


def ring_probe(torch, bb, params, cfg, batch) -> dict:
    """``decode_gap`` of a sliding-window model at the prompts of
    RING_PROBE_OFFSETS, each from RING_PROBE_SEEDS: {prompt: [gap a
    seed]}. A misplaced ring slot would put a wrong key in the window, an
    error of the logits' own size; rounding stays at one size across
    wraps and seeds."""
    out = {}
    for mult, extra in RING_PROBE_OFFSETS:
        prompt = mult * cfg.window + extra
        out[prompt] = []
        for seed in RING_PROBE_SEEDS:
            tokens, _ = lm_inputs(torch, cfg, batch, prompt + 1, seed=seed)
            batch_in = {"tokens": tokens[:, :-1]}
            _, cache, idx = bb.prefill(params, cfg, batch_in, prompt + 1)
            out[prompt].append(decode_gap(torch, bb, params, cfg, batch_in,
                                          cache, idx, tokens[:, -1:]))
            del cache
    print(f"{cfg.name}: a decode step vs forward by prompt length (ring "
          f"{cfg.window}), seeds {RING_PROBE_SEEDS}: " + "; ".join(
              f"{p}: " + ", ".join(f"{e:.3g}" for e in errs)
              for p, errs in out.items()) + f" (tol {LM_DECODE_TOL})")
    return out


def lm_family(torch, counted, name, layers=None, batch=2, prompt=128,
              patches=0, frames=0, gen=8, profile=False) -> tuple:
    """One family at full width through serve_lm on the card, from random
    weights of seed 0: init (peak memory), a warm-up, then prefill and
    ``gen`` greedy decode steps with the launches counted per stage and
    asserted (``expected_launches``, every other kernel 0); prefill's
    last logits against ``forward``; a decode step after prefill against
    forward on the extended sequence, where the two agree by design (not
    with MoE layers, whose capacity depends on the tokens a call, nor
    with M-RoPE, whose decode position is the raw index), and for a
    sliding window at the prompts of ``ring_probe``; with ``profile`` a
    profiled prefill and decode step. Returns (the record, params,
    cfg)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import backbone as bb

    cfg = cut_cfg(get_config(name), layers)
    decode_vs_forward = not cfg.n_experts and cfg.pos != "mrope"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bb.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens, inputs = lm_inputs(torch, cfg, batch, prompt, patches, frames)
    seq = patches + prompt
    max_len = seq + gen
    print(f"{cfg.name}: {cfg.n_layers} layers"
          f"{f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''}, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters "
          f"({n_params * 4 / 1e9:.3f} GB f32); init {init_s:.2f} s, peak "
          f"{init_peak_gb:.3f} GB")
    warm = {k: v[:, :16] for k, v in inputs.items()}
    serve_lm.generate(params, cfg, tokens[:, :16], gen=1, max_len=max_len,
                      inputs=warm)

    stages = []

    def hook(stage, i):
        stages.append((stage, {k: m.launches for k, m in counted.items()}))
        for m in counted.values():
            m.launches = 0

    for m in counted.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.generate(params, cfg, tokens, gen=gen, max_len=max_len,
                            inputs=inputs, hook=hook)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_p, want_d = expected_launches(cfg)
    want_prefill = {k: want_p.get(k, 0) for k in counted}
    want_decode = {k: want_d.get(k, 0) for k in counted}
    check(stages[0] == ("prefill", want_prefill),
          f"{cfg.name} prefill launches {stages[0]}, want {want_prefill}")
    check(len(stages) == 1 + gen and all(
        got == ("decode", want_decode) for got in stages[1:]),
        f"{cfg.name} decode launches {stages[1:3]}..., want {want_decode} a step")
    toks = res["tokens"]
    check(tuple(toks.shape) == (batch, 1 + gen)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{cfg.name}: generated tokens out of range")
    steps = np.asarray(res["decode_s"])
    out = {"name": cfg.name, "layers": cfg.n_layers, "n_params": n_params,
           "batch": batch, "prompt": prompt, "patches": patches, "frames": frames,
           "gen": gen, "init_s": init_s, "init_peak_gb": init_peak_gb,
           "launches_prefill": {k: v for k, v in want_prefill.items() if v},
           "launches_decode_step": {k: v for k, v in want_decode.items() if v},
           "launches": {k: sum(c[k] for _, c in stages) for k in counted},
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms_per_step": float(steps.mean() * 1e3),
           "decode_ms_median": float(np.median(steps) * 1e3),
           "tokens_per_s": batch * gen / float(steps.sum()),
           "prefill_tokens_per_s": batch * seq / res["prefill_s"],
           "peak_gb": peak_gb}
    print(f"serve_lm {cfg.name}: prefill {seq} tokens x{batch} "
          f"{out['prefill_ms']:.3f} ms ({out['prefill_tokens_per_s']:.0f} "
          f"tokens/s); {gen} decode steps {steps.sum() * 1e3:.3f} ms "
          f"({out['tokens_per_s']:.1f} tokens/s, {out['decode_ms_per_step']:.3f} "
          f"ms a step, median {out['decode_ms_median']:.3f}); peak memory "
          f"{peak_gb:.3f} GB; launches a prefill {out['launches_prefill']}, a "
          f"step {out['launches_decode_step']}, nothing else")

    batch_in = {"tokens": tokens, **inputs}
    with torch.no_grad():
        logits, cache, idx = bb.prefill(params, cfg, batch_in, max_len)
        full, _ = bb.forward(params, cfg, batch_in)
        a, b = logits[:, 0], full[:, -1]
        out["prefill_vs_forward"] = float((a - b).abs().max())
        check(bool(torch.isfinite(full[:, -1]).all()) and torch.allclose(
            a, b, atol=LM_PREFILL_TOL, rtol=LM_PREFILL_TOL),
            f"{cfg.name} prefill vs forward: {out['prefill_vs_forward']}")
        del full
        nt = toks[:, 1:2]
        if decode_vs_forward:
            out["decode_vs_forward"] = decode_gap(torch, bb, params, cfg, batch_in,
                                                  cache, idx, nt)
    print(f"{cfg.name}: prefill vs forward last logits max abs err "
          f"{out['prefill_vs_forward']:.3g} (tol {LM_PREFILL_TOL})" + (
              f"; a decode step vs forward on the extended sequence "
              f"{out['decode_vs_forward']:.3g} (tol {LM_DECODE_TOL})"
              if decode_vs_forward else ""))
    if decode_vs_forward and cfg.attn_kind == "sliding":
        with torch.no_grad():
            out["ring_probe"] = ring_probe(torch, bb, params, cfg, batch)
    if profile:
        with torch.no_grad():
            bd_p = device_breakdown(
                lambda: bb.prefill(params, cfg, batch_in, max_len),
                res["prefill_s"], top=8, match=LM_KERNELS)
            # the profiled steps write into a clone of the prefill's cache
            step_cache = bb.clone_cache(cache)
            bd_d = device_breakdown(
                lambda: bb.decode_step(params, cfg, nt, step_cache, idx),
                float(np.median(steps)), top=8, match=LM_KERNELS)
            del step_cache
        print_breakdown(f"{cfg.name} prefill", bd_p)
        print_breakdown(f"{cfg.name} decode step", bd_d)
        for label, bd in (("prefill", bd_p), ("decode step", bd_d)):
            print(f"    {label}: " + ", ".join(
                f"{k} {v['ms']:.3f} ms in {v['calls']}"
                for k, v in bd["matched"].items()))
        out["breakdown"] = {"prefill": bd_p, "decode": bd_d}
    del cache, logits
    return out, params, cfg


@contextlib.contextmanager
def moe_recording(fn_name, on=True):
    """Within the block, each call of ``models.moe.<fn_name>`` appends
    its outputs to the list yielded (``on`` false: nothing is wrapped)."""
    from repro_torch.models import moe

    record, orig = [], getattr(moe, fn_name)

    def wrapped(*args):
        out = orig(*args)
        record.append(out)
        return out

    if on:
        setattr(moe, fn_name, wrapped)
    try:
        yield record
    finally:
        setattr(moe, fn_name, orig)


def lm_serve_pass(torch, bb, params, cfg, tokens, inputs, gen, feed=None):
    """Prefill, then ``gen`` decode steps fed ``feed`` (B, gen) or, without
    it, greedy tokens. Returns ([logits of prefill and each step], caches
    after prefill and after the last step, the tokens fed)."""
    seq = tokens.shape[1] + (inputs["patches"].shape[1] if "patches" in inputs
                             else 0)
    logits, cache, idx = bb.prefill(params, cfg, {"tokens": tokens, **inputs},
                                    seq + gen)
    # the steps write into ``cache``: the prefill's is kept as a clone
    out, caches, fed = [logits], [bb.clone_cache(cache)], []
    for i in range(gen):
        nt = (torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
              if feed is None else feed[:, i:i + 1].to(tokens.device))
        fed.append(nt.cpu())
        logits, cache = bb.decode_step(params, cfg, nt, cache, idx + i)
        out.append(logits)
    caches.append(cache)
    return out, caches, torch.cat(fed, 1) if fed else None


def lm_family_card_vs_cpu(torch, params, cfg, layers, batch, prompt, gen,
                          patches=0, frames=0, tol=LM_CPU_TOL) -> dict:
    """The model cut to ``layers`` on the card and on the CPU from the same
    weights: prefill, then ``gen`` decode steps fed the CPU's greedy
    tokens; logits and caches within ``tol``. With MoE layers, every
    router call's expert choices equal on both, and the prompt seed the
    first whose CPU run keeps each token's top-k / (k+1) probability gap
    at least MOE_GAP."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import backbone as bb

    sub, scfg = cut_depth(params, cfg, layers)
    cpu_params = tree_map(lambda x: x.cpu(), sub)
    moe = scfg.n_experts > 0
    worst = {}

    def compare(key, a, b):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            x, y = x.cpu(), y.cpu()
            err = float((x - y).abs().max())
            worst[key] = max(worst.get(key, 0.0), err)
            check(x.shape == y.shape and torch.allclose(x, y, atol=tol, rtol=tol),
                  f"{scfg.name} card vs CPU {key}: max abs err {err}")

    with torch.no_grad():
        for seed in range(MOE_SEEDS if moe else 1):
            tokens, inputs = lm_inputs(torch, scfg, batch, prompt, patches, frames,
                                       seed=seed, device="cpu")
            with moe_recording("_route", moe) as routes:
                cpu_logits, cpu_caches, fed = lm_serve_pass(
                    torch, bb, cpu_params, scfg, tokens, inputs, gen)
            if not moe:
                break
            gaps = [float((torch.topk(p, scfg.top_k + 1, dim=-1).values[:, -2]
                           - torch.topk(p, scfg.top_k + 1, dim=-1).values[:, -1]).min())
                    for _, _, p in routes]
            worst["moe_smallest_gap"] = min(gaps)
            worst["moe_seed"] = seed
            if min(gaps) >= MOE_GAP:
                break
        check(not moe or worst["moe_smallest_gap"] >= MOE_GAP,
              f"{scfg.name}: no prompt seed of {MOE_SEEDS} keeps the top-k gap "
              f"{MOE_GAP}: {worst.get('moe_smallest_gap')}")
        with moe_recording("_route", moe) as card_routes:
            card_logits, card_caches, _ = lm_serve_pass(
                torch, bb, sub, scfg, tokens.cuda(),
                {k: v.cuda() for k, v in inputs.items()}, gen, feed=fed)
    if moe:
        check(len(card_routes) == len(routes) and all(
            torch.equal(torch.sort(a.cpu(), -1).values, torch.sort(b, -1).values)
            for (_, a, _), (_, b, _) in zip(card_routes, routes)),
            f"{scfg.name} card vs CPU: the routers chose other experts")
        worst["router_calls"] = len(routes)
    for a, b in zip(card_logits, cpu_logits):
        compare("logits", a, b)
    for a, b in zip(card_caches, cpu_caches):
        compare("cache", a, b)
    print(f"card vs CPU, {scfg.name} at {scfg.n_layers} layers, prefill {batch} x "
          f"{patches + prompt}{f' ({frames} frames)' if frames else ''} + {gen} "
          f"decode steps: max abs err {worst} (tol atol = rtol = {tol})")
    return worst


def lm_phases(torch, counted) -> dict:
    """Phases 23-25: phi4-mini-3.8b at full width and depth, then card
    against CPU at 2 of its layers, then every other family
    (FAMILY_RUNS). Returns {config name: record}."""
    from repro_torch.configs import get_config
    from repro_torch.models import backbone as bb

    runs = {}
    phase("23 full-width phi4-mini-3.8b serving")
    rec, params, cfg = lm_family(torch, counted, "phi4_mini_3p8b",
                                 batch=PHI4_BATCH, prompt=PHI4_PROMPT,
                                 gen=PHI4_GEN, profile=True)
    runs[cfg.name] = rec

    phase("24 phi4-mini-3.8b card against CPU")
    rec["card_vs_cpu"] = lm_family_card_vs_cpu(torch, params, cfg, layers=2,
                                               batch=2, prompt=64, gen=4)
    del params
    print("phi4-mini-3.8b serving: " + json.dumps(
        {k: v for k, v in rec.items() if k != "breakdown"}))

    phase("25 the other families at full width, card against CPU")
    for run in FAMILY_RUNS:
        t0 = time.perf_counter()
        run = dict(run)
        cpu_run = run.pop("cpu")
        rec, params, cfg = lm_family(torch, counted, **run)
        if cfg.n_experts:
            tokens, _ = lm_inputs(torch, cfg, run["batch"], run["prompt"])
            with torch.no_grad(), moe_recording("_dispatch_indices") as slots:
                bb.prefill(params, cfg, {"tokens": tokens}, run["prompt"] + run["gen"])
            rec["moe_dropped"] = int(sum(int((~keep).sum()) for _, keep in slots))
            rec["moe_assignments"] = int(sum(keep.numel() for _, keep in slots))
            print(f"{cfg.name} prefill: {rec['moe_dropped']} of "
                  f"{rec['moe_assignments']} (token, expert) assignments "
                  f"dropped at capacity (factor {cfg.capacity_factor})")
        if cpu_run is not None:
            rec["card_vs_cpu"] = lm_family_card_vs_cpu(torch, params, cfg, **cpu_run)
        del params
        torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t0
        runs[get_config(run["name"]).name] = rec
        print(f"-- {cfg.name}: {rec['phase_s']:.1f} s")
    print("lm families: " + json.dumps(
        {name: {k: v for k, v in r.items() if k != "breakdown"}
         for name, r in runs.items()}))
    return runs


# Two correct runs of one model at bf16 compute (the port against the
# reference on the CPU, the card against the CPU, a decode step against
# the same step with every kernel's plain version) round the same values
# at each bf16 stage from f32 sums taken in other orders, so a stage's
# two outputs may differ by one bf16 ulp an entry: at most 2^-7 of the
# entry (8 significant bits), so at most 2^-7 of its row's norm (a row:
# the last axis, one token's logits or one head's key). Distinct
# roundings differ independently and with no sign preferred, so along a
# row's path their norms add in quadrature; each stage carries its
# input's relative difference at unit gain. After r roundings two runs
# then agree within sqrt(r) 2^-7 of each row's norm. A block rounds at
# most BF16_ROUNDINGS_PER_LAYER times on a row's path (attention: norm,
# projection, RoPE, attention, output projection, residual; MLP: norm,
# up / gate, activation, product, down, residual; the hybrid's fusion
# and the xLSTM pair's two blocks fit the same count), and embedding,
# final norm and head add BF16_ROUNDINGS_OUTSIDE. A tensor is held to
# the roundings upstream of it: the logits to every block's, a stacked
# cache leaf's layer i to those of the blocks up to and including i.
BF16_ROUNDINGS_PER_LAYER = 16
BF16_ROUNDINGS_OUTSIDE = 3


def bf16_roundings(cfg, blocks=None) -> int:
    """The bf16 roundings upstream of the logits (``blocks`` None) or of
    what the first ``blocks`` blocks (the encoder's first) leave."""
    n = cfg.n_layers + cfg.n_enc_layers if blocks is None else blocks
    return BF16_ROUNDINGS_PER_LAYER * n + BF16_ROUNDINGS_OUTSIDE


def bf16_share(got, want, roundings: int, row_axes: int = 1) -> float:
    """The largest share, over the rows (the last ``row_axes`` axes), of
    |got - want| in the bound sqrt(roundings) 2^-7 |want| (norms of the
    row, in f64); above 1 the two are further apart than two correct bf16
    runs can be. A row of want's zeros must be matched exactly. ``got``
    and ``want`` are numpy arrays or tensors of one shape."""
    got, want = (np.asarray(x.detach().float().cpu() if hasattr(x, "detach") else x,
                            dtype=np.float64) for x in (got, want))
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    if got.size == 0:
        return 0.0
    row = int(np.prod(want.shape[-row_axes:]))
    err = np.linalg.norm((got - want).reshape(-1, row), axis=-1)
    bound = np.sqrt(roundings) * 2.0 ** -7 * np.linalg.norm(
        want.reshape(-1, row), axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(err == 0, 0.0, err / bound)
    return float(share.max())


def bf16_cache_share(cfg, got, want) -> float:
    """``bf16_share`` of two decode caches, given as lists of their
    stacked leaves in one order (one layer a slice of the leading axis),
    leaf by leaf and layer by layer: layer i held to the roundings of the
    blocks through i (a slice spans n_layers / slices decoder blocks,
    after every encoder block). A row is a leaf's last two axes: one
    token's K or V over the heads, or one head's recurrent state (the
    mLSTM's and the Mamba heads' C is a decayed sum over the tokens of
    k v^T, whose rows may cancel where its terms do not; the rounding of
    a sum scales with its terms)."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        per = cfg.n_layers // w.shape[0]
        for i in range(w.shape[0]):
            worst = max(worst, bf16_share(
                g[i], w[i], bf16_roundings(cfg, cfg.n_enc_layers + per * (i + 1)),
                row_axes=2))
    return worst


# Phase 33: the reference's production variants (src/repro/launch/
# specs.py, dryrun_config) on one card through launch/specs.py: each
# family's one-card share (one data shard's rows, the whole model) of
# prefill_32k (2 x 32768), decode_32k (8 rows, a 32768-slot cache) and
# long_500k (1 row; the window-4096 variant of the quadratic families)
# at bf16 compute with f32 parameters and a bf16 cache. Family, depth
# (None: as published; the cuts of phase 25).
PRODUCTION_RUNS = (("phi4_mini_3p8b", None), ("hymba_1p5b", None),
                   ("xlstm_350m", None), ("qwen2_vl_2b", None),
                   ("whisper_medium", None), ("deepseek_moe_16b", 4),
                   ("starcoder2_7b", 2), ("nemotron_4_15b", 2),
                   ("stablelm_3b", 2), ("dbrx_132b", 2))
PRODUCTION_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# every entry that runs (phases 33 and 34): its measured peak memory at
# most PEAK_OVER_COUNT times ``dryrun.held_terms``'s count, and the count
# at most COUNT_OVER_PEAK times the peak
PEAK_OVER_COUNT, COUNT_OVER_PEAK = 1.10, 1.5
DRYRUN_RUN = ("xlstm-350m", "long_500k")  # the entry ``dryrun --run`` takes
# phi4's decode_32k cache comes from its own prefill of 2 rows (the
# prefill_32k share) of 32767 tokens, tiled to the 8 rows (a prefill of
# all 8 took 15.6 s of the run's limit); every other
# decode cache holds random bf16 K/V from the seed (the reference's
# decode entry takes its cache as an argument) and zero recurrent states.
PRODUCTION_PREFILLED = ("phi4_mini_3p8b",)
PRODUCTION_PREFILL_ROWS = 2
PRODUCTION_DECODE_STEPS = 5  # timed decode steps; the median is kept
PRODUCTION_WARM_SEQ = 2048  # a prefill entry's warm-up length
# card vs CPU in bf16 (every family at 2 layers, dbrx at 1 as in phase
# 25): rows, prompt tokens (vision patches, audio frames) and steps;
# deepseek's grouped dispatch at 4 groups (prefill: 2 x 16 tokens in
# groups of 8; a step's 2 tokens take the flat path, as in the reference)
PRODUCTION_CPU = dict(batch=2, prompt=16, gen=2)
PRODUCTION_CPU_LAYERS = {"dbrx_132b": 1}
PRODUCTION_CPU_INPUTS = {"qwen2_vl_2b": dict(patches=64),
                         "whisper_medium": dict(frames=200)}
PRODUCTION_CPU_GROUPS = {"deepseek_moe_16b": 4}
# the flash kernel at the production entries' shapes, bf16: (b, hq, hkv,
# sq, sk, d, causal, window), the K/V layout ("bshd": a decode cache read
# where it lies, the way decode_attend passes it) and the entry; every
# family's prefill_32k form (each dense, MoE and VLM family at full
# attention; their long_500k decode is the 4096 ring)
FLASH_PRODUCTION_CASES = (
    ((2, 24, 8, 32768, 32768, 128, True, 0), "bhsd", "phi4 prefill_32k"),
    ((8, 24, 8, 1, 32768, 128, False, 0), "bshd", "phi4 decode_32k"),
    ((1, 24, 8, 1, 4096, 128, False, 0), "bshd", "phi4 long_500k (ring 4096)"),
    ((2, 25, 5, 32768, 32768, 64, True, 1024), "bhsd", "hymba prefill_32k"),
    ((8, 25, 5, 1, 1024, 64, False, 0), "bshd", "hymba decode_32k (ring 1024)"),
    ((2, 12, 2, 32768, 32768, 128, True, 0), "bhsd", "qwen2-vl prefill_32k"),
    ((8, 12, 2, 1, 32768, 128, False, 0), "bshd", "qwen2-vl decode_32k"),
    ((2, 36, 4, 32768, 32768, 128, True, 0), "bhsd", "starcoder2 prefill_32k"),
    ((2, 48, 8, 32768, 32768, 128, True, 0), "bhsd",
     "nemotron and dbrx prefill_32k"),
    ((2, 16, 16, 32768, 32768, 128, True, 0), "bhsd", "deepseek prefill_32k"),
    ((2, 32, 32, 32768, 32768, 80, True, 0), "bhsd", "stablelm prefill_32k"),
    ((8, 32, 32, 1, 32768, 80, False, 0), "bshd", "stablelm decode_32k"),
    ((2, 16, 16, 32768, 1500, 64, False, 0), "bhsd", "whisper cross, prefill_32k"),
    ((8, 16, 16, 1, 1500, 64, False, 0), "bhsd", "whisper cross, decode_32k"),
)
# past 1024 queries the first, middle and last FLASH_CHECK_ROWS rows are
# checked; the last batch row's and head's are among them, whose keys lie
# at the largest offsets the kernel forms
FLASH_CHECK_ROWS = 128
# the control: the kernel fed V with this share of the keys (a band in
# the middle) negated, held against the plain version of the true V,
# must fall outside the bound (a kernel that misreads that many keys
# fails the check) at the entries named here
FLASH_CONTROL_SHARE = 0.25
FLASH_CONTROL_ENTRIES = ("phi4 prefill_32k", "phi4 decode_32k")
# each timing (the kernel's, SDPA's) runs about this many ms of calls, at
# least 3 and at most 100
FLASH_PRODUCTION_TIMED_MS = 200.0


def flash_production_inputs(torch, case, layout, seed):
    """bf16 q (B, Hq, Sq, d) and k, v (B, Hkv, Sk, d) on the card, normal;
    odd query heads at 4 times the scale, so that their softmax rests on
    a few keys (a row's output then moves with any key it misreads); with
    ``bshd`` K/V are transposed views of (B, Sk, Hkv, d) arrays."""
    b, hq, hkv, sq, sk, d = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q = draw(b, hq, sq, d)
    q[:, 1::2] *= 4
    if layout == "bshd":
        return q, draw(b, sk, hkv, d).transpose(1, 2), draw(b, sk, hkv, d).transpose(1, 2)
    return q, draw(b, hkv, sk, d), draw(b, hkv, sk, d)


def flash_check_rows(sq: int) -> list:
    """The (first, end) query rows checked: all up to 1024, else the
    first, middle and last FLASH_CHECK_ROWS (queries end-aligned: the
    first rows see the first keys, the middle half of them, the last all)."""
    n = FLASH_CHECK_ROWS
    if sq <= 1024:
        return [(0, sq)]
    return [(0, n), (sq // 2 - n // 2, sq // 2 + n // 2), (sq - n, sq)]


def flash_share(torch, fref, q, k, v, out, causal, window) -> tuple:
    """``out`` against the plain version on the rows of ``flash_check_rows``
    (each part given the keys up to its last row's, so that queries stay
    end-aligned): the largest share of ``fref.bf16_error_bound`` (inf if
    ``out`` is not finite there) and the largest |out - plain|."""
    sq, sk = q.shape[2], k.shape[2]
    check(causal or window == 0 or sq <= 1024, "a window needs causal rows here")
    worst, worst_abs = 0.0, 0.0
    for lo, hi in flash_check_rows(sq):
        end = hi + sk - sq if causal else sk
        qq, kk, vv, got = q[:, :, lo:hi], k[:, :, :end], v[:, :, :end], out[:, :, lo:hi]
        if not bool(torch.isfinite(got).all()):
            return float("inf"), float("inf")
        want = fref.flash_attention_ref(qq, kk, vv, causal=causal, window=window)
        bound = fref.bf16_error_bound(qq, kk, vv, got, want, causal=causal,
                                      window=window)
        err = (got.float() - want.float()).abs()
        share = torch.where(err == 0, torch.zeros_like(err), err / bound)
        worst = max(worst, float(share.max()))
        worst_abs = max(worst_abs, float(err.max()))
        del want, bound, err, share
    return worst, worst_abs


# the recurrent kernels at their prefill_32k shapes (f32, after the cast
# the reference also makes), from the reference kernel tests'
# distributions: xlstm-350m's mLSTM and hymba-1.5b's Mamba heads (b, h,
# s, dk, dv, chunk, normalize), xlstm-350m's sLSTM (b, h, s, hd) from the
# zero state. Each whole launch is held against its plain recurrence on
# a window of RECURRENT_WINDOW steps at each end (the plain loops over
# all 32768 steps took 41.5 s, over windows of 4096 22 s, of 2048 18 s):
# the first window from the zero state;
# the last, for the mLSTM, from the zero state too, its second half
# compared (log_f = -0.2 |N(0, 1)| decays what came before the window by
# about e^-82 over its first half, far below f32's resolution, so
# there the window is the whole recurrence), and for the sLSTM from the
# state the kernel reaches at its start (a launch of the steps before
# it), all of it compared, with the final state.
MLSTM_PRODUCTION_CASES = ((2, 4, 32768, 512, 512, 64, True),
                          (2, 25, 32768, 16, 64, 64, False))
SLSTM_PRODUCTION_CASE = (2, 4, 32768, 256)
RECURRENT_WINDOW = 1024


def within(name, got, want, bound) -> float:
    """``got`` finite and within ``bound`` of ``want``; the max abs err."""
    e = (got - want).abs()
    check(got.shape == want.shape and bool(got.isfinite().all())
          and bool((e <= bound).all()), f"{name} beyond its bound: {float(e.max())}")
    return float(e.max())


def recurrent_production(torch, mlaunch, mref, slaunch, sref) -> dict:
    """MLSTM_PRODUCTION_CASES (h, final C and n) within mlstm_error_bound
    and SLSTM_PRODUCTION_CASE (h, final (c, n, m, h)) within
    slstm_error_bound of their plain versions on the windows above; their
    max abs errors."""
    out, w = {}, RECURRENT_WINDOW
    for b, h, s, dk, dv, chunk, normalize in MLSTM_PRODUCTION_CASES:
        t0 = time.perf_counter()
        q, k, v, lf = mlstm_inputs(torch, b, h, s, dk, dv, seed=s + dk)
        got, (c, n) = mlaunch.mlstm_scan_cuda(q, k, v, lf, chunk=chunk,
                                              normalize=normalize, return_state=True)
        head = mref.mlstm_scan_ref(q[:, :, :w], k[:, :, :w], v[:, :, :w], lf[:, :, :w],
                                   normalize=normalize)
        tail, (wc, wn) = mref.mlstm_scan_ref(q[:, :, -w:], k[:, :, -w:], v[:, :, -w:],
                                             lf[:, :, -w:], normalize=normalize,
                                             return_state=True)
        torch.cuda.synchronize()
        tag = f"mlstm_scan {(b, h, s, dk, dv)}"
        errs = {"h first": within(f"{tag} h", got[:, :, :w], head,
                                  mref.mlstm_error_bound(head)),
                "h last": within(f"{tag} h", got[:, :, -w // 2:], tail[:, :, -w // 2:],
                                 mref.mlstm_error_bound(tail[:, :, -w // 2:])),
                "C": within(f"{tag} C", c, wc, mref.mlstm_error_bound(wc)),
                "n": within(f"{tag} n", n, wn, mref.mlstm_error_bound(wn))}
        del q, k, v, lf, got, head, tail
        out[tag] = errs
        print(f"{tag} chunk {chunk} normalize={normalize}: the first {w} and last "
              f"{w // 2} steps' h and the final C and n within mlstm_error_bound of "
              f"the plain recurrence; max abs errs {errs} "
              f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    b, h, s, hd = SLSTM_PRODUCTION_CASE
    pre, r = slstm_inputs(torch, b, h, s, hd, seed=s + hd)
    got, fin = slaunch.slstm_cell_cuda(pre, r, return_state=True)
    _, start = slaunch.slstm_cell_cuda(pre[:, :, :s - w].contiguous(), r,
                                       return_state=True)
    head = sref.slstm_cell_ref(pre[:, :, :w], r)
    tail, wfin = sref.slstm_cell_ref(pre[:, :, s - w:], r, start, return_state=True)
    torch.cuda.synchronize()
    tag = f"slstm_cell {SLSTM_PRODUCTION_CASE}"
    worst = max(within(f"{tag} h", got[:, :, :w], head,
                       sref.slstm_error_bound(head, got[:, :, :w])),
                within(f"{tag} h", got[:, :, s - w:], tail,
                       sref.slstm_error_bound(tail, got[:, :, s - w:])),
                *(within(f"{tag} final state", g, x, sref.slstm_error_bound(x, g))
                  for g, x in zip(fin, wfin)))
    out[tag] = worst
    print(f"{tag}: the first and last {w} steps' h (the last from the kernel's "
          f"state at step {s - w}) and the final (c, n, m, h) within "
          f"slstm_error_bound of the plain recurrence; max abs err {worst:.3g} "
          f"({time.perf_counter() - t0:.1f} s)")
    return out


def largest_offset(x) -> int:
    """The largest element offset the kernel forms into ``x``'s storage."""
    return x.storage_offset() + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))


def flash_production(torch, flaunch, fref, mem_rate) -> list:
    """The flash kernel at FLASH_PRODUCTION_CASES in bf16: against its
    plain version within ``fref.bf16_error_bound`` (``flash_share``), the
    control at FLASH_CONTROL_ENTRIES, then timed with CUDA events beside
    scaled_dot_product_attention (K/V repeated to the query heads
    outside the timed call, so that SDPA's fused kernels take it; a
    window as a boolean mask) and the bound (bytes of q, k, v and the
    output over the memory rate, or 4 d operations a visible pair at the
    bf16 tensor-core rate)."""
    F = torch.nn.functional
    out = []
    for case, layout, entry in FLASH_PRODUCTION_CASES:
        b, hq, hkv, sq, sk, d, causal, window = case
        q, k, v = flash_production_inputs(torch, case, layout, seed=sq + d + hq)
        before = flaunch.launches
        got = flaunch.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(flaunch.launches == before + 1, f"flash {entry}: not one launch")
        err, abs_err = flash_share(torch, fref, q, k, v, got, causal, window)
        check(err <= 1.0, f"flash {entry} at {case[:6]}: {err} of its bf16 bound")
        del got
        control = None
        if entry in FLASH_CONTROL_ENTRIES:
            band = slice(int(sk * (1 - FLASH_CONTROL_SHARE) / 2),
                         int(sk * (1 + FLASH_CONTROL_SHARE) / 2))
            wrong = v.clone()
            wrong[:, :, band] = -wrong[:, :, band]
            bad = flaunch.flash_attention_cuda(q, k, wrong, causal=causal, window=window)
            control = flash_share(torch, fref, q, k, v, bad, causal, window)[0]
            check(control > 1.0, f"flash {entry}: V with {FLASH_CONTROL_SHARE} of "
                  f"its keys negated gave {control} of the bound")
            del wrong, bad
        offsets = max(largest_offset(x) for x in (q, k, v))

        def kern():
            return flaunch.flash_attention_cuda(q, k, v, causal=causal, window=window)

        one = cuda_time_ms(kern, iters=1, warmup=1)
        iters = int(min(100, max(3, FLASH_PRODUCTION_TIMED_MS / max(one, 1e-3))))
        ms = cuda_time_ms(kern, iters=iters, warmup=1)
        kr = k.repeat_interleave(hq // hkv, dim=1) if hq != hkv else k
        vr = v.repeat_interleave(hq // hkv, dim=1) if hq != hkv else v
        mask = None
        if window > 0:  # visible_mask's keys, built on the card
            qi = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
            ki = torch.arange(sk, device="cuda")[None, :]
            mask = (ki > qi - window) & ((ki <= qi) if causal else True)
        check(not causal or sq == sk, "SDPA's causal mask needs Sq == Sk")

        def sdpa():
            return F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=mask, is_causal=causal and mask is None)

        library_ms = cuda_time_ms(sdpa, iters=iters, warmup=1)
        del kr, vr, mask
        nbytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * 2
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = (4 * d * visible_pairs(sq, sk, causal, window) * b * hq
                  / BF16_OPS_PER_S * 1e3)
        rec = {"entry": entry, "shape": [b, hq, hkv, sq, sk, d], "causal": causal,
               "window": window, "kv_layout": layout, "dtype": "bfloat16",
               "bound_share_vs_plain": err, "max_abs_err": abs_err,
               "control_share": control,
               "largest_offset": offsets, "ms": ms, "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        rec["bound_share"] = rec["bound_ms"] / ms
        rec["vs_library"] = ms / library_ms
        print(f"flash bf16 {entry} {case[:6]} {layout}: {ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; {rec['bound_share']:.3f} of it); against plain "
              f"{err:.3g} of the bf16 bound"
              + (f" (control: {control:.3g})" if control is not None else "")
              + f"; largest element offset {offsets} (2^31 = {2 ** 31})")
        out.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def patched(patches):
    """Within the block, each (module, name, fn) of ``patches`` sets
    ``module.name`` to fn; restored after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """Within the block, each kernel wrapper's CUDA call runs the kernel's
    plain version on the card's tensors instead (no launch, no count)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.kernels.slstm_cell import ops as sops
    from repro_torch.kernels.slstm_cell import ref as sref

    def flash(q, k, v, *, causal, window, softcap=0.0):
        return fref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        softcap=softcap)

    def slstm(pre_x, r, initial_state=None, return_state=False):
        return sref.slstm_cell_ref(pre_x, r, initial_state, return_state)

    def mlstm(q, k, v, log_f, *, chunk, normalize, return_state=False):
        return mref.mlstm_scan_ref(q, k, v, log_f, normalize=normalize,
                                   return_state=return_state)

    with patched(((fops, "flash_attention_cuda", flash), (sops, "slstm_cell_cuda", slstm),
                  (mops, "mlstm_scan_cuda", mlstm))):
        yield


def cache_states(cache, path=()) -> list:
    """The recurrent-state leaves of a decode cache (all but the K/V rings
    and the cross-attention K/V), which a step replaces."""
    if isinstance(cache, dict):
        return [x for key, val in cache.items() if key not in ("k", "v", "cross")
                for x in cache_states(val, path + (key,))]
    if isinstance(cache, (list, tuple)):
        return [x for val in cache for x in cache_states(val, path)]
    return [cache]


def prefilled_decode_args(torch, cfg, shape, params, seed=0) -> tuple:
    """decode_32k's arguments from the port's own prefill:
    PRODUCTION_PREFILL_ROWS rows of shape.seq - 1 random tokens through
    the prefill entry (max_len shape.seq), written into each group of as
    many rows of one shape.batch-row bf16 cache; then their next tokens
    at index seq - 1."""
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.models import backbone as bb

    rows = PRODUCTION_PREFILL_ROWS
    check(shape.batch % rows == 0, f"{shape.batch} rows in groups of {rows}")
    cache = bb.init_cache(cfg, shape.batch, shape.seq, torch.bfloat16,
                          enc_len=SP.ENC_FRAMES, device="cuda")
    fn, _ = SP.make_entry(cfg, SP.ShapeSpec("prefill", "prefill", shape.seq, rows))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            rows, shape.seq - 1)).astype(np.int32)).cuda()
        logits, part, idx = fn(params, {"tokens": tokens})
        check(idx == shape.seq - 1, f"prefill index {idx}")
        for i in range(0, shape.batch, rows):
            tree_map(lambda dst, src: dst[:, i:i + rows].copy_(src), cache, part)
        nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        del part, logits
    return params, nxt.repeat(shape.batch // rows, 1), cache, shape.seq - 1


@contextlib.contextmanager
def kernel_calls_vs_plain():
    """Within the block, every call of a kernel wrapper's CUDA function
    also runs the kernel's plain version on the same inputs and holds the
    kernel's output (and final state) to the kernel's own bound: flash in
    bf16 ``fref.bf16_error_bound``, in f32 ``fref.TOL``; the sLSTM
    ``slstm_error_bound``; the mLSTM ``mlstm_error_bound``. Every stage
    of a step but the kernels is the same code on the same card, so
    given one input it gives the same bits; each kernel call is checked
    on the input the step gives it. Yields {kernel: [calls, the largest
    share of its bound]}."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.kernels.slstm_cell import ops as sops
    from repro_torch.kernels.slstm_cell import ref as sref

    seen = {}

    def note(kernel, pairs, bounds):
        worst = 0.0
        for (g, w), bound in zip(pairs, bounds):
            err = (g.float() - w.float()).abs()
            check(g.shape == w.shape and bool(torch.isfinite(g.float()).all()),
                  f"{kernel} call: shape or non-finite values")
            worst = max(worst, float(torch.where(err == 0, torch.zeros_like(err),
                                                 err / bound).max()))
        calls = seen.setdefault(kernel, [0, 0.0])
        calls[0] += 1
        calls[1] = max(calls[1], worst)

    def flash(q, k, v, *, causal, window, softcap=0.0, _cuda=fops.flash_attention_cuda):
        got = _cuda(q, k, v, causal=causal, window=window, softcap=softcap)
        want = fref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        softcap=softcap)
        bound = (fref.bf16_error_bound(q, k, v, got, want, causal=causal,
                                       window=window, softcap=softcap)
                 if got.dtype == torch.bfloat16 else
                 fref.TOL[got.dtype] * (1 + want.float().abs()))
        note("flash_attention", [(got, want)], [bound])
        return got

    def slstm(pre_x, r, initial_state=None, return_state=False,
              _cuda=sops.slstm_cell_cuda):
        got = _cuda(pre_x, r, initial_state, return_state)
        want = sref.slstm_cell_ref(pre_x, r, initial_state, return_state)
        pairs = (list(zip((got[0], *got[1]), (want[0], *want[1]))) if return_state
                 else [(got, want)])
        note("slstm_cell", pairs, [sref.slstm_error_bound(w, g) for g, w in pairs])
        return got

    def mlstm(q, k, v, log_f, *, chunk, normalize, return_state=False,
              _cuda=mops.mlstm_scan_cuda):
        got = _cuda(q, k, v, log_f, chunk=chunk, normalize=normalize,
                    return_state=return_state)
        want = mref.mlstm_scan_ref(q, k, v, log_f, normalize=normalize,
                                   return_state=return_state)
        pairs = (list(zip((got[0], *got[1]), (want[0], *want[1]))) if return_state
                 else [(got, want)])
        note("mlstm_scan", pairs, [mref.mlstm_error_bound(w) for _, w in pairs])
        return got

    with patched(((fops, "flash_attention_cuda", flash), (sops, "slstm_cell_cuda", slstm),
                  (mops, "mlstm_scan_cuda", mlstm))):
        yield seen


def production_entry(torch, counted, cfg, shape, params, prefilled, base) -> dict:
    """One entry of ``specs.make_entry`` on the card: its meta sizing and
    roofline (``dryrun.size_entry``), its arguments (``dryrun.
    materialize``, or ``prefilled_decode_args``), a warm-up call, then
    with every count at 0 the timed run (``dryrun.time_entry``; prefill:
    one call; decode: PRODUCTION_DECODE_STEPS steps at the entry's index,
    the median kept) and its launches, asserted (``expected_launches``);
    finite bf16 logits of the right shape; and for decode, the step
    against the same step with every kernel's plain version on the card:
    each kernel call held to its own bound on the input the step gives it
    (``kernel_calls_vs_plain``), and the logits to ``bf16_share``'s bound
    at every block's roundings (the recurrent states restored between).
    The peak memory above ``base`` (what was allocated before the
    parameters) is held against the sizing's count: at most
    PEAK_OVER_COUNT times it, and the count at most COUNT_OVER_PEAK
    times the peak."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.launch.roofline import CARD_BYTES

    size = dryrun.size_entry(cfg, shape)
    check(size["held_bytes"] <= CARD_BYTES,
          f"{cfg.name} x {shape.name}: {size['held_bytes'] / 1e9:.2f} GB")
    fn, _ = SP.make_entry(cfg, shape)
    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    args = (prefilled_decode_args(torch, cfg, shape, params) if prefilled
            else dryrun.materialize(cfg, shape, cuda, params=params))
    setup_s = time.perf_counter() - t0
    want = expected_launches(cfg)[0 if shape.kind == "prefill" else 1]
    steps = 1 if shape.kind == "prefill" else PRODUCTION_DECODE_STEPS
    with torch.no_grad():
        # warm-up: a decode step, or a prefill of PRODUCTION_WARM_SEQ
        # tokens (the same kernels and products at a shorter length)
        if shape.kind == "prefill":
            warm = dataclasses.replace(shape, seq=min(shape.seq, PRODUCTION_WARM_SEQ))
            SP.make_entry(cfg, warm)[0](*dryrun.materialize(
                cfg, warm, cuda, params=params))
        else:
            fn(*args)
    for m in counted.values():
        m.launches = 0
    timed, out = dryrun.time_entry(fn, args, steps=steps, warmup=False)
    launches = {k: m.launches for k, m in counted.items()}
    logits = out[0]
    del out
    wanted = {k: want.get(k, 0) * steps for k in counted}
    check(launches == wanted, f"{cfg.name} x {shape.name} launches {launches}, "
          f"want {wanted}")
    check(logits.dtype == torch.bfloat16 and tuple(logits.shape) == (
        shape.batch, 1, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()),
        f"{cfg.name} x {shape.name}: logits {logits.dtype} {tuple(logits.shape)}")
    ms, peak_gb = timed["ms"], timed["peak_gb"] - base / 1e9
    tokens = shape.batch * (shape.seq if shape.kind == "prefill" else 1)
    rec = {"shape": shape.name, "batch": shape.batch, "seq": shape.seq,
           "layers": cfg.n_layers, "moe_groups": cfg.moe_groups,
           "attn_kind": cfg.attn_kind, "setup_s": setup_s, "ms": ms,
           "ms_all": timed["ms_all"], "tokens_per_s": tokens / (ms / 1e3),
           "peak_gb": peak_gb, "held_gb": size["held_bytes"] / 1e9,
           "peak_over_held": peak_gb * 1e9 / size["held_bytes"],
           "bound_ms": size["roofline"]["bound_ms"],
           "bottleneck": size["roofline"]["bottleneck"],
           "launches": {k: v // steps for k, v in launches.items() if v}}
    rec["roofline_share"] = rec["bound_ms"] / ms
    if shape.kind == "decode":
        _, tokens_in, cache, index = args
        states = cache_states(cache)
        saved = [x.clone() for x in states]

        def step():
            for x, s in zip(states, saved):
                x.copy_(s)
            return fn(params, tokens_in, cache, index)[0]

        # MoE: the plain step takes the kernel step's expert choices
        # (``moe_forced``, as card vs CPU does), the picks it would have
        # changed counted
        moe = cfg.n_experts > 0
        with torch.no_grad():
            with moe_recording("_route", moe) as routes, kernel_calls_vs_plain() as calls:
                kern = step()
            forced = moe_forced(routes) if moe else contextlib.nullcontext({})
            with plain_kernels(), forced as picks:
                plain = step()
            for x, s in zip(states, saved):
                x.copy_(s)
        rec["kernel_calls_vs_plain"] = {k: {"calls": n, "bound_share": w}
                                        for k, (n, w) in calls.items()}
        check(calls.keys() == rec["launches"].keys()
              and all(n == rec["launches"][k] and w <= 1.0
                      for k, (n, w) in calls.items()),
              f"{cfg.name} x {shape.name}: kernel calls against plain {calls}")
        rec["vs_plain"] = bf16_share(kern, plain, bf16_roundings(cfg))
        if moe:
            rec["router_picks_differing"] = picks["differ"]
        check(rec["vs_plain"] <= 1.0, f"{cfg.name} x {shape.name}: a step vs its "
              f"plain kernels at {rec['vs_plain']} of the bf16 bound")
        del kern, plain, saved
    print(f"{cfg.name} x {shape.name} ({shape.batch} x {shape.seq}, "
          f"{cfg.n_layers} layers, {cfg.attn_kind}, moe_groups {cfg.moe_groups}): "
          f"{ms:.3f} ms{' a step' if shape.kind == 'decode' else ''}, "
          f"{rec['tokens_per_s']:.1f} tokens/s, peak {peak_gb:.2f} GB (the count "
          f"{rec['held_gb']:.2f}: {rec['peak_over_held']:.3f} of it), bound "
          f"{rec['bound_ms']:.3f} ms "
          f"({rec['bottleneck']}; {rec['roofline_share']:.3f} of it); launches "
          f"{rec['launches']}" + (f"; each kernel call vs plain (calls, share of its "
                                  f"bound) {rec['kernel_calls_vs_plain']}; logits "
                                  f"vs plain kernels {rec['vs_plain']:.3g} of the bf16 "
                                  f"bound" if "vs_plain" in rec else "")
          + (f", router picks the plain step would change "
             f"{rec['router_picks_differing']}"
             if "router_picks_differing" in rec else "")
          + f"; arguments {setup_s:.1f} s")
    check(rec["peak_over_held"] <= PEAK_OVER_COUNT
          and rec["peak_over_held"] * COUNT_OVER_PEAK >= 1.0,
          f"{cfg.name} x {shape.name}: peak {peak_gb:.2f} GB against the count's "
          f"{rec['held_gb']:.2f}")
    del args, logits
    return rec


@contextlib.contextmanager
def moe_forced(routes):
    """Within the block, the i-th call of ``models.moe._route`` keeps its
    own probabilities but takes the expert choices of ``routes[i]`` (an
    earlier run's ``_route`` outputs, in their order), its gates
    renormalized from its own probabilities at those experts. Yields
    {"differ": (token, k) picks its own choice would have changed,
    "picks": all picks}."""
    import torch
    from repro_torch.models import moe

    orig, state = moe._route, {"i": 0, "differ": 0, "picks": 0}

    def forced(p, cfg, xf):
        _, idx, probs = orig(p, cfg, xf)
        want = routes[state["i"]][1].to(idx.device)
        state["i"] += 1
        state["differ"] += int((torch.sort(idx, -1).values
                                != torch.sort(want, -1).values).sum())
        state["picks"] += idx.numel()
        gates = torch.gather(probs, -1, want)
        return gates / (gates.sum(-1, keepdim=True) + 1e-9), want, probs

    moe._route = forced
    try:
        yield state
    finally:
        moe._route = orig


def production_card_vs_cpu(torch, params, cfg, layers, batch, prompt, gen,
                           patches=0, frames=0) -> dict:
    """``cfg`` (bf16 compute) cut to ``layers`` on the card and on the CPU
    from the same weights: prefill (bf16 cache), then ``gen`` decode steps
    fed the CPU's greedy tokens; logits within ``bf16_share``'s bound at
    every block's roundings, each cache leaf's layer i at those of the
    blocks through i (``bf16_cache_share``). MoE layers take the CPU's
    expert choices on the card (``moe_forced``): in bf16 the k-th and
    (k+1)-th router logits are often within the two runs' rounding of
    each other, so the count of picks the card would have made otherwise
    is reported, and the rest of the layer is compared."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import backbone as bb

    sub, scfg = cut_depth(params, cfg, layers)
    cpu_params = tree_map(lambda x: x.cpu(), sub)
    moe = scfg.n_experts > 0
    worst = {}

    def compare(key, share):
        worst[key] = max(worst.get(key, 0.0), share)
        check(share <= 1.0, f"{scfg.name} bf16 card vs CPU {key}: {share} of the "
              "bf16 bound")

    with torch.no_grad():
        tokens, inputs = lm_inputs(torch, scfg, batch, prompt, patches, frames,
                                   device="cpu")
        with moe_recording("_route", moe) as routes:
            cpu_logits, cpu_caches, fed = lm_serve_pass(
                torch, bb, cpu_params, scfg, tokens, inputs, gen)
        forced = moe_forced(routes) if moe else contextlib.nullcontext({})
        with forced as picks:
            card_logits, card_caches, _ = lm_serve_pass(
                torch, bb, sub, scfg, tokens.cuda(),
                {k: v.cuda() for k, v in inputs.items()}, gen, feed=fed)
    for a, b in zip(card_logits, cpu_logits, strict=True):
        compare("logits", bf16_share(a, b, bf16_roundings(scfg)))
    for a, b in zip(card_caches, cpu_caches, strict=True):
        compare("cache", bf16_cache_share(scfg, [x.cpu() for x in tree_leaves(a)],
                                          tree_leaves(b)))
    if moe:
        worst.update(router_picks=picks["picks"], router_picks_differing=picks["differ"])
    print(f"bf16 card vs CPU, {scfg.name} at {scfg.n_layers} layers (moe_groups "
          f"{scfg.moe_groups}), prefill {batch} x {patches + prompt}"
          f"{f' ({frames} frames)' if frames else ''} + {gen} steps: worst share "
          f"of the bf16 bound {worst}")
    return worst


def production_phase(torch, counted, kernels, mem_rate) -> dict:
    """Phase 33: the flash kernel at the production shapes
    (``flash_production``) and the recurrent kernels at theirs
    (``recurrent_production``); the meta-device sizing of every entry
    (``dryrun --all``: 40 records, none failing) and of the federated
    round (``--blendfl``); ``dryrun --run`` on DRYRUN_RUN; then each family of
    PRODUCTION_RUNS at full width (its depth cut where given), from random
    weights of seed 0: every entry of PRODUCTION_SHAPES it has
    (``production_entry``), then bf16 card vs CPU at 2 layers
    (``production_card_vs_cpu``). Returns the records."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.models import backbone as bb

    flaunch, fref, mlaunch, mref, slaunch, sref = kernels
    out = {"flash": flash_production(torch, flaunch, fref, mem_rate),
           "recurrent": recurrent_production(torch, mlaunch, mref, slaunch, sref)}
    t0 = time.perf_counter()
    sizing = dryrun.main(["--all"])
    check(len(sizing) == 40 and all(r["status"] in ("ok", "skip", "does_not_fit")
                                    for r in sizing), "dryrun --all")
    out["dryrun_blendfl"] = dryrun.main(["--blendfl"])[0]
    out["dryrun"] = {f"{r['arch']} x {r['shape']}": r["status"] for r in sizing}
    print(f"dryrun sizing: {time.perf_counter() - t0:.1f} s")
    # the CLI's --run on one small entry (random weights, its own timing)
    t0 = time.perf_counter()
    ran = dryrun.main(["--arch", DRYRUN_RUN[0], "--shape", DRYRUN_RUN[1], "--run"])[0]
    check(ran["status"] == "ok" and np.isfinite(ran["run"]["ms"])
          and ran["run"]["peak_gb"] > 0, f"dryrun --run {DRYRUN_RUN}: {ran}")
    out["dryrun_run"] = ran["run"]
    del ran
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dryrun --run {DRYRUN_RUN}: {time.perf_counter() - t0:.1f} s")
    out["runs"] = {}
    for name, layers in PRODUCTION_RUNS:
        t0 = time.perf_counter()
        first = SP.one_card_config(name, SP.SHAPES["prefill_32k"])
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = bb.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cut_cfg(first, layers), device="cuda")
        fam = {"entries": {}}
        for shape_name in PRODUCTION_SHAPES:
            cfg = SP.one_card_config(name, SP.SHAPES[shape_name])
            if cfg is None:
                fam["entries"][shape_name] = {"status": "skip", "reason":
                                              "no sub-quadratic form (the reference's skip)"}
                print(f"{name} x {shape_name}: skipped, as the reference skips it")
                continue
            shape = SP.one_card_shape(SP.SHAPES[shape_name])
            fam["entries"][shape_name] = production_entry(
                torch, counted, cut_cfg(cfg, layers), shape, params,
                prefilled=name in PRODUCTION_PREFILLED and shape_name == "decode_32k",
                base=base)
            gc.collect()
            torch.cuda.empty_cache()
        cpu_cfg = first.replace(moe_groups=PRODUCTION_CPU_GROUPS.get(
            name, first.moe_groups))
        fam["card_vs_cpu"] = production_card_vs_cpu(
            torch, params, cpu_cfg, PRODUCTION_CPU_LAYERS.get(name, 2),
            **PRODUCTION_CPU, **PRODUCTION_CPU_INPUTS.get(name, {}))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        fam["phase_s"] = time.perf_counter() - t0
        out["runs"][get_config(name).name] = fam
        print(f"-- {name}: {fam['phase_s']:.1f} s")
    print("production serving: " + json.dumps(out))
    return out


# ----------------------------------------- production training (15c-1) --

# Phase 34: the reference's production variant trains (src/repro/launch/
# specs.py, dryrun_config: bf16 compute, f32 parameters, remat) through
# ``specs.make_entry`` at train_4k's one-card share: 16 rows of 4096
# positions in ``default_microbatches`` microbatches (xlstm 1, hymba 2,
# the rest 8), the in-place AdamW step. Family and depth (None: as
# published); phi4-mini runs only if the sizing says it fits.
TRAIN_4K_RUNS = (("hymba_1p5b", None), ("xlstm_350m", None), ("qwen2_vl_2b", 2),
                 ("stablelm_3b", 2), ("whisper_medium", 2), ("phi4_mini_3p8b", None))
TRAIN_4K_STEPS = 2  # timed steps after a warm-up step; the median is kept
# the flash backward at the train_4k attentions (hymba: 8 rows a
# microbatch, its window; qwen2-vl: 2 rows of 1024 patches + 3072
# tokens), on bf16 inputs cast up to f32 as ``FlashAttentionFn`` feeds it
FLASH_BWD_4K_CASES = (
    ("hymba train_4k", (8, 25, 5, 4096, 4096, 64, True, 1024, 0.0)),
    ("qwen2-vl train_4k", (2, 12, 2, 4096, 4096, 128, True, 0, 0.0)),
)
# the mLSTM backward at train_4k's scans: xlstm's (16 rows) and hymba's
# Mamba heads (8 rows a microbatch)
MLSTM_BWD_4K_CASES = (("xlstm train_4k", (16, 4, 4096, 512, 512, True)),
                      ("hymba train_4k", (8, 25, 4096, 16, 64, False)))
# the sLSTM BPTT at xlstm-350m's train_4k step: (rows, heads, S, head dim)
SLSTM_BWD_4K = ("xlstm train_4k", (16, 4, 4096, 256))
# card against CPU, and remat against none on the card, at 2 layers and
# phase 32's narrow widths in bf16 with remat, 2 x 128 tokens
TRAIN_4K_CPU = {"hymba_1p5b": dict(d_model=256, head_dim=32, n_heads=5,
                                   n_kv_heads=1, window=64),
                "xlstm_350m": dict(d_model=256)}


def grad_roundings(cfg) -> int:
    """The bf16 roundings upstream of a parameter's gradient: the
    forward's (``bf16_roundings``), then as many again on the way back
    (the backward rounds at the same bf16 boundaries)."""
    return 2 * bf16_roundings(cfg)


def flash_bwd_4k(torch, flaunch, fbwd, fref, mem_rate) -> dict:
    """At each FLASH_BWD_4K_CASES shape, bf16 q, k, v: the forward with its
    log-sum-exp equal bit for bit to the forward without it, its lse and
    output against the plain version, and the f32 backward kernels on the
    inputs cast up against the plain backward, on the first and the last
    (batch row, K/V group) in full (every row of both), within
    ``flash_grad_error_bound``; ``FlashAttentionFn``'s bf16 gradients
    equal to those kernels' cast down. Timed: the kernels alone, the
    whole bf16 backward (the casts up and down with them), SDPA's bf16
    backward on K/V repeated to the query heads (a window as a boolean
    mask; a yardstick, never on the path) and the kernels' bound at the
    f32 inputs. Returns {label: record}."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    F = torch.nn.functional
    out = {}
    for label, case in FLASH_BWD_4K_CASES:
        b, hq, hkv, sq, sk, d, causal, window, softcap = case
        form = dict(causal=causal, window=window, softcap=softcap)
        group = hq // hkv
        q, k, v = flash_inputs(torch, b, hq, hkv, sq, sk, d, seed=sq + hq,
                               dtype=torch.bfloat16)
        o, lse = flaunch.flash_attention_cuda(q, k, v, return_lse=True, **form)
        check(torch.equal(o, flaunch.flash_attention_cuda(q, k, v, **form)),
              f"{label}: the bf16 forward with its lse differs from the one without")
        dout = torch.from_numpy(np.random.default_rng(sq).standard_normal(
            (b, hq, sq, d), np.float32)).cuda().to(torch.bfloat16)
        xs = [x.float() for x in (q, k, v, o, dout)]
        before = fbwd.launches
        got = fbwd.flash_attention_bwd_cuda(*xs, lse, **form)
        torch.cuda.synchronize()
        n = fbwd.kernels_a_call(sq, sk, group)
        check(fbwd.launches - before == n, f"{label}: flash backward launches")
        errs, shares = {}, {}
        for bi, g in ((0, 0), (b - 1, hkv - 1)):  # the first and last slices
            qs = slice(g * group, (g + 1) * group)
            sl = [xs[0][bi:bi + 1, qs], xs[1][bi:bi + 1, g:g + 1],
                  xs[2][bi:bi + 1, g:g + 1], xs[3][bi:bi + 1, qs],
                  xs[4][bi:bi + 1, qs]]
            want_o, want_lse = fref.flash_attention_ref(*sl[:3], return_lse=True,
                                                        **form)
            tol = fref.TOL[torch.float32]
            got_lse = lse[bi:bi + 1, qs]
            fin = torch.isfinite(want_lse)
            check(torch.equal(fin, torch.isfinite(got_lse)) and bool(
                ((got_lse - want_lse)[fin].abs() <= tol + tol * want_lse[fin].abs()).all()),
                f"{label}: the bf16 forward's lse beyond {tol} of plain")
            check(bool((o[bi:bi + 1, qs].float() - want_o).abs().le(
                fref.bf16_error_bound(*sl[:3], sl[3], want_o, **form)).all()),
                f"{label}: the bf16 forward's output beyond its bound")
            want = fref.flash_attention_bwd_ref(*sl, lse[bi:bi + 1, qs], **form)
            for name, gt, w in zip(("dq", "dk", "dv"), (
                    got[0][bi:bi + 1, qs], got[1][bi:bi + 1, g:g + 1],
                    got[2][bi:bi + 1, g:g + 1]), want):
                err = (gt - w).abs()
                bound = fref.flash_grad_error_bound(w)
                check(bool(torch.isfinite(gt).all()) and bool((err <= bound).all()),
                      f"{label} flash backward {name} beyond its bound: max err "
                      f"{float(err.max())}")
                errs[name] = max(errs.get(name, 0.0), float(err.max()))
                shares[name] = max(shares.get(name, 0.0), float((err / bound).max()))
            del want, want_o, want_lse
        # the wrapper's path: the bf16 forward, then the kernels on the
        # inputs cast up and the gradients cast down
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        with torch.enable_grad():
            lo = flash_attention(qg, kg, vg, **form)
        grads = torch.autograd.grad(lo, (qg, kg, vg), dout, retain_graph=True)
        check(all(gr.dtype == torch.bfloat16 and torch.equal(gr, g32.to(torch.bfloat16))
                  for gr, g32 in zip(grads, got)),
              f"{label}: FlashAttentionFn's bf16 gradients are not the kernels' cast down")
        del got, grads
        t = {"shape": list(case[:6]), "causal": causal, "window": window,
             "kernels_a_call": n, "max_abs_err": errs, "share_of_bound": shares,
             "ms": cuda_time_ms(lambda: fbwd.flash_attention_bwd_cuda(*xs, lse, **form),
                                iters=5, warmup=1),
             "bf16_path_ms": cuda_time_ms(lambda: torch.autograd.grad(
                 lo, (qg, kg, vg), dout, retain_graph=True), iters=5, warmup=1)}
        t.update(flash_bwd_lm_bound_ms(case, mem_rate))
        del lo, xs
        mask = (torch.from_numpy(visible_mask(sq, sk, causal, window)).cuda()
                if window > 0 else None)
        sq_, sk_, sv_ = (x.detach().requires_grad_() for x in (q, k, v))
        with torch.enable_grad():
            so = F.scaled_dot_product_attention(
                sq_, sk_.repeat_interleave(group, 1), sv_.repeat_interleave(group, 1),
                attn_mask=mask, is_causal=causal and mask is None)
        t["library_backend"] = so.grad_fn.name()
        t["library_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
            so, (sq_, sk_, sv_), dout, retain_graph=True), iters=5, warmup=1)
        del so, sq_, sk_, sv_, mask
        print(f"flash backward, {label} {case} (bf16 inputs cast up): kernels "
              f"{t['ms']:.3f} ms ({n} a call), the bf16 path (casts included) "
              f"{t['bf16_path_ms']:.3f} ms; SDPA bf16 backward ({t['library_backend']}) "
              f"{t['library_ms']:.3f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['gflop']:.1f} GFLOP; {t['bound_ms_simt']:.4f} "
              f"on SIMT f32): the kernels at {t['bound_ms'] / t['ms']:.3f} / "
              f"{t['bound_ms_simt'] / t['ms']:.3f} of them; max abs err {errs}, "
              f"share of the bound {shares} (first and last slices); forward "
              f"with lse bit for bit the forward without")
        out[label] = t
        del q, k, v, o, lse, dout, qg, kg, vg
        torch.cuda.empty_cache()
    return out


def end_slices(torch, x, b, h):
    """The first and the last (batch row, head) of x (B, H, ...), stacked
    as a (2, 1, ...) batch."""
    return torch.stack([x[0, 0], x[b - 1, h - 1]])[:, None]


def mlstm_bwd_4k(torch, mlaunch, mbwd, mem_rate) -> dict:
    """The mLSTM backward kernels at MLSTM_BWD_4K_CASES (the forward
    kernel's h, a random output gradient): the whole call's gradients
    finite, and on the first and the last (batch row, head) in full
    (every one of the S = 4096 steps) against the plain backward on the
    same inputs, each within ``mlstm_grad_error_bound`` (the plain
    backward of the whole call would take minutes); then timed beside
    their bound: operations at the 3xTF32 rate, or bytes
    (``time_mlstm_bwd``'s count)."""
    from repro_torch.kernels.mlstm_scan import ref as mref

    out = {}
    for label, case in MLSTM_BWD_4K_CASES:
        b, h, s, dk, dv, normalize = case
        xs = mlstm_bwd_inputs(torch, mlaunch, b, h, s, dk, dv, normalize, seed=s)
        got = mbwd.mlstm_scan_bwd_cuda(*xs, normalize=normalize)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"mlstm backward at {label}: non-finite gradients")
        q, k, v, lf, h_out, dh = (end_slices(torch, x, b, h) for x in xs)
        want, dq_scale = mref.mlstm_scan_bwd_ref(q, k, v, lf, dh, h=h_out,
                                                 normalize=normalize, dq_scale=True)
        errs, shares = {}, {}
        for name, g, w in zip(("dq", "dk", "dv", "dlog_f"), got, want):
            e = (end_slices(torch, g, b, h) - w).abs()
            bound = mref.mlstm_grad_error_bound(w, dq_scale if name == "dq" else None)
            errs[name], shares[name] = float(e.max()), float((e / bound).max())
            check(bool((e <= bound).all()),
                  f"mlstm backward {name} at {label}, first and last (row, head), "
                  f"beyond its bound: max err {errs[name]}, {shares[name]:.3f} "
                  f"of the bound")
        del got, want, dq_scale, q, k, v, lf, h_out, dh
        torch.cuda.empty_cache()
        nbytes = 4 * b * h * (s * (2 * dk + dv + 1 + dv + int(normalize) * dv)
                              + s * (2 * dk + dv + 1))
        flops = mlstm_bwd_flops(b, h, s, dk, dv, normalize)
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = 3 * flops / TF32_OPS_PER_S * 1e3
        t = {"shape": list(case[:5]), "normalize": normalize,
             "ms": cuda_time_ms(lambda: mbwd.mlstm_scan_bwd_cuda(
                 *xs, normalize=normalize), iters=5, warmup=1),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bound_ms_simt": max(bytes_ms, flops / FP32_OPS_PER_S * 1e3),
             "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
             "max_abs_err": errs, "share_of_bound": shares}
        print(f"mlstm_scan_bwd at {label} {t['shape']} normalize={normalize}: "
              f"{t['ms']:.4f} ms a call; bound {t['bound_ms']:.4f} ms at the 3xTF32 "
              f"rate ({t['bound_by']}, {t['gflop']:.2f} GFLOP, {t['mbytes']:.0f} MB), "
              f"{t['bound_ms_simt']:.4f} on SIMT f32: the call at "
              f"{t['bound_ms'] / t['ms']:.3f} / {t['bound_ms_simt'] / t['ms']:.3f}; "
              f"first and last (row, head) against the plain backward: max abs "
              f"err {errs}, share of the bound {shares}")
        out[label] = t
        del xs
        torch.cuda.empty_cache()
    return out


def slstm_bwd_4k(torch, mem_rate) -> dict:
    """The sLSTM BPTT kernel at SLSTM_BWD_4K, xlstm-350m's train_4k step
    (random pre-activations and r on the card, the saving forward
    kernel's gate sums and states, a random output gradient): the saving
    forward's output and saved tensors against the plain forward, within
    ``slstm_error_bound``, and the backward against the plain backward
    on those saved tensors, within ``slstm_grad_error_bound``, both on
    the first and the last batch row in full (every head and every one
    of the S = 4096 steps; the plain recurrences of the whole batch
    would take a step loop of 16 rows); then timed beside its bound
    (``slstm_bwd_bound_ms``)."""
    from repro_torch.kernels.slstm_cell import ref as sref
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as sbwd

    label, (rows, h, s, hd) = SLSTM_BWD_4K
    gen = torch.Generator(device="cuda").manual_seed(s)
    pre = torch.randn((rows, h, s, 4, hd), generator=gen, device="cuda") * 0.5
    r = torch.randn((h, hd, 4 * hd), generator=gen, device="cuda") / hd ** 0.5
    dhs = torch.randn((rows, h, s, hd), generator=gen, device="cuda")
    out, saved = slaunch.slstm_cell_cuda(pre, r, save=True)
    got = sbwd.slstm_cell_bwd_cuda(saved, r, dhs)
    check(bool(torch.isfinite(got).all()), f"slstm_cell_bwd at {label}: non-finite")
    ends = [0, rows - 1]
    errs, shares = {}, {}
    for name, g, w in zip(("output", "saved"), (out[ends], saved[ends]),
                          sref.slstm_cell_ref(pre[ends], r, save=True)):
        e = (g - w).abs()
        bound = sref.slstm_error_bound(w, g)
        errs[name], shares[name] = float(e.max()), float((e / bound).max())
        check(bool((e <= bound).all()),
              f"slstm_cell saving forward's {name} at {label}, first and last "
              f"rows, beyond its bound: max err {errs[name]}")
    want = sref.slstm_cell_bwd_ref(saved[ends], r, dhs[ends])
    e = (got[ends] - want).abs()
    bound = sref.slstm_grad_error_bound(want)
    errs["dpre"], shares["dpre"] = float(e.max()), float((e / bound).max())
    check(bool((e <= bound).all()),
          f"slstm_cell_bwd at {label}, first and last rows, beyond its bound: "
          f"max err {errs['dpre']}, {shares['dpre']:.3f} of the bound")
    del got, want, e, bound, out, pre
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: sbwd.slstm_cell_bwd_cuda(saved, r, dhs), iters=5,
                      warmup=1)
    bound_ms, by = slstm_bwd_bound_ms(rows, 1, h, s, hd, mem_rate)
    t = {"shape": [rows, h, s, hd], "ms": ms, "bound_ms": bound_ms, "bound_by": by,
         "max_abs_err": errs, "share_of_bound": shares}
    print(f"slstm_cell_bwd at {label} {t['shape']}: {ms:.4f} ms a call; bound "
          f"{bound_ms:.4f} ms ({by}): the call at {bound_ms / ms:.3f}; first and "
          f"last rows against the plain forward and backward: max abs err {errs}, "
          f"share of the bound {shares}")
    del saved, r, dhs
    torch.cuda.empty_cache()
    return {label: t}


def train_4k_run(torch, counted, name, layers) -> dict:
    """One TRAIN_4K_RUNS family at train_4k's one-card share through
    ``specs.make_entry``'s train step: the sizing (``dryrun.size_entry``;
    a family that does not fit prints its record and stops there), the
    arguments (``dryrun.materialize``, from seed 0), a warm-up step, then
    TRAIN_4K_STEPS timed steps with every count at 0: finite losses, the
    launches ``train_launches`` gives a microbatch times the
    microbatches (two forwards under remat), ms a step (median),
    tokens/s, the peak memory above what was allocated before the
    arguments, held against the count; then one step profiled (busy /
    idle) and the roofline's shares: its bound (``launch/roofline.py``)
    and the reference's 6 N D (``model_flops``) at the bf16 peak."""
    import gc

    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.launch.roofline import BF16_OPS_PER_S, CARD_BYTES, model_flops

    shape = SP.SHAPES["train_4k"]
    cfg = cut_cfg(SP.one_card_config(name, shape), layers)
    oshape = SP.one_card_shape(shape)
    mb = SP.default_microbatches(name, shape)
    size = dryrun.size_entry(cfg, oshape, mb)
    rec = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "batch": oshape.batch, "seq": oshape.seq, "microbatches": mb,
           "held_gb": size["held_bytes"] / 1e9,
           "held_terms_gb": {k: v / 1e9 for k, v in size["held_terms"].items()}}
    if size["held_bytes"] > CARD_BYTES:
        rec["status"] = "does_not_fit"
        print(f"{cfg.name} x train_4k ({oshape.batch} x {oshape.seq}, {mb} "
              f"microbatches, {cfg.n_layers} layers): does_not_fit, held "
              f"{size['held_bytes'] / 1e9:.2f} GB of {CARD_BYTES / 1e9:.0f} "
              f"({rec['held_terms_gb']}); not run")
        return rec
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    fn, _ = SP.make_entry(cfg, oshape, mb)
    t0 = time.perf_counter()
    args = dryrun.materialize(cfg, oshape, torch.device("cuda"))
    setup_s = time.perf_counter() - t0
    batch = args[2]
    patches = cfg.vision_tokens if cfg.frontend == "vision_stub" else 0
    frames = batch["frames"].shape[1] if "frames" in batch else 0
    text = batch["tokens"].shape[1]
    per = train_launches(cfg, text, patches=patches, frames=frames)
    want = dict.fromkeys(counted, 0) | {k: v * mb * TRAIN_4K_STEPS for k, v in per.items()}
    losses, secs = [], []
    with torch.no_grad():
        t0 = time.perf_counter()
        losses.append(float(fn(*args)[2]["loss"]))  # the warm-up step
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in counted.values():
            m.launches = 0
        for _ in range(TRAIN_4K_STEPS):
            ts = time.perf_counter()
            metrics = fn(*args)[2]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
            losses.append(float(metrics["loss"]))
        launches = {k: m.launches for k, m in counted.items()}
        peak = torch.cuda.max_memory_allocated() - base
        ms = float(np.median(secs)) * 1e3
        bd = device_breakdown(lambda: fn(*args), ms / 1e3, top=8,
                              match=("flash_kernel", "dq_kernel", "dkv_kernel",
                                     "mlstm_kernel", "mlstm_bwd", "slstm_kernel",
                                     "slstm_bwd_kernel", "gemm"))
    check(all(np.isfinite(x) for x in losses), f"{cfg.name} x train_4k losses {losses}")
    check(launches == want, f"{cfg.name} x train_4k launches {launches}, want {want}")
    tokens = oshape.batch * (text + patches)
    mf = model_flops(cfg, "train", oshape.batch, text + patches)
    rec.update(status="ok", setup_s=setup_s, first_step_ms=first_s * 1e3,
               ms_a_step=ms, ms_all=[x * 1e3 for x in secs],
               tokens_per_s=tokens / (ms / 1e3), peak_gb=peak / 1e9,
               peak_over_held=peak / size["held_bytes"],
               bound_ms=size["roofline"]["bound_ms"],
               roofline_share=size["roofline"]["bound_ms"] / ms,
               model_flops_share=mf / BF16_OPS_PER_S * 1e3 / ms, losses=losses,
               launches_a_step={k: v // TRAIN_4K_STEPS for k, v in launches.items() if v},
               breakdown=bd)
    print(f"{cfg.name} x train_4k ({oshape.batch} x {text + patches} tokens in {mb} "
          f"microbatches, {cfg.n_layers} layers"
          f"{f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''}, bf16, "
          f"remat): {ms:.1f} ms a step (median of {TRAIN_4K_STEPS} after a warm-up "
          f"step of {first_s * 1e3:.1f}), {rec['tokens_per_s']:.0f} tokens/s; peak "
          f"{peak / 1e9:.2f} GB against the count's {size['held_bytes'] / 1e9:.2f} "
          f"({rec['peak_over_held']:.3f} of it; terms {rec['held_terms_gb']}); bound "
          f"{rec['bound_ms']:.1f} ms ({rec['roofline_share']:.3f} of it), 6ND at the "
          f"bf16 peak {rec['model_flops_share']:.3f}; busy {bd['busy_ms']:.1f} ms, "
          f"idle {bd['idle_share']:.3f}; losses {[round(x, 4) for x in losses]}; "
          f"launches a step {rec['launches_a_step']}; arguments {setup_s:.1f} s")
    print_breakdown(f"a {cfg.name} train_4k step (profiled)", bd)
    for m, v in bd["matched"].items():
        print(f"    {m}: {v['ms']:.3f} ms in {v['calls']} launches")
    check(peak <= PEAK_OVER_COUNT * size["held_bytes"]
          and size["held_bytes"] <= COUNT_OVER_PEAK * peak,
          f"{cfg.name} x train_4k: peak {peak / 1e9:.2f} GB against the count's "
          f"{size['held_bytes'] / 1e9:.2f}")
    del args, fn, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_4k_card_vs_cpu(torch, counted, name) -> dict:
    """``name`` at TRAIN_4K_CPU's narrow widths, 2 layers, bf16 with
    remat, from the same weights (seed 0, drawn on the CPU): the loss and
    every gradient of one batch of CARD_CPU_BATCH x CARD_CPU_SEQ tokens on
    the card against the CPU, the loss within ``bf16_share``'s bound at
    the forward's roundings and each gradient leaf (as one row) at
    ``grad_roundings``; on the card ``train_launches`` (two forwards a
    layer); then on the card without remat, each leaf within one
    rounding's bound (2^-7 of its norm: f32 sums in another order) of the
    step with it, and whether they are equal bit for bit."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_batch
    from repro_torch.models import backbone as bb

    cfg = get_config(name).reduced().replace(compute_dtype="bfloat16", remat=True,
                                             **TRAIN_4K_CPU[name])
    cpu_params = bb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card_params = tree_map(lambda x: x.cuda(), cpu_params)
    batch = build_batch(cfg, CARD_CPU_BATCH, CARD_CPU_SEQ, np.random.default_rng(0))

    def run(params, c, dev):
        for m in counted.values():
            m.launches = 0
        total, _, grads = bb._value_and_grad(
            params, c, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        return (float(total), [g.cpu() for g in tree_leaves(grads)],
                {k: m.launches for k, m in counted.items()})

    cpu = run(cpu_params, cfg, "cpu")
    card = run(card_params, cfg, "cuda")
    plain = run(card_params, cfg.replace(remat=False), "cuda")
    want = dict.fromkeys(counted, 0) | train_launches(cfg, CARD_CPU_SEQ)
    check(card[2] == want, f"{cfg.name} bf16 card launches {card[2]}, want {want}")
    r = bf16_roundings(cfg)
    loss_share = bf16_share(np.array([card[0]]), np.array([cpu[0]]), r)
    grad_share = max(bf16_share(a, b, grad_roundings(cfg), row_axes=b.dim())
                     for a, b in zip(card[1], cpu[1]))
    remat_share = max(bf16_share(a, b, 1, row_axes=b.dim())
                      for a, b in zip(card[1], plain[1]))
    equal = sum(torch.equal(a, b) for a, b in zip(card[1], plain[1]))
    rec = {"loss_share": loss_share, "grad_share": grad_share,
           "remat_vs_none_share": remat_share, "remat_vs_none_loss_equal":
           card[0] == plain[0], "remat_vs_none_leaves_equal": [equal, len(card[1])],
           "launches": card[2]}
    print(f"{cfg.name} bf16 training card vs CPU (2 layers, d {cfg.d_model}, remat, "
          f"{CARD_CPU_BATCH} x {CARD_CPU_SEQ} tokens): the loss at {loss_share:.3g} "
          f"of the bf16 bound ({r} roundings), gradients at most {grad_share:.3g} "
          f"({grad_roundings(cfg)}); launches {card[2]}; without remat on the card: "
          f"gradients at most {remat_share:.3g} of one rounding's bound, {equal} of "
          f"{len(card[1])} leaves and the loss "
          f"{'equal' if card[0] == plain[0] else 'not equal'} bit for bit")
    check(loss_share <= 1.0 and grad_share <= 1.0,
          f"{cfg.name} bf16 card vs CPU: loss {loss_share}, gradients {grad_share}")
    check(remat_share <= 1.0, f"{cfg.name} remat against none on the card: "
          f"{remat_share} of one rounding's bound")
    return rec


def production_training(torch, counted, kernels, mem_rate) -> dict:
    """Phase 34: the train_4k sizing of every family (``dryrun --shape
    train_4k``: 10 records, none failing), the flash backward at the
    train_4k attentions (``flash_bwd_4k``), the mLSTM backward at its
    scans (``mlstm_bwd_4k``) and the sLSTM BPTT at xlstm's
    (``slstm_bwd_4k``), card against CPU and remat against none at
    2 layers (``train_4k_card_vs_cpu``), then each TRAIN_4K_RUNS family's
    steps (``train_4k_run``); hymba-1.5b and xlstm-350m whole must run.
    Returns the records."""
    from repro_torch.launch import dryrun

    flaunch, fbwd, fref, mlaunch, mbwd = kernels
    t0 = time.perf_counter()
    sizing = dryrun.main(["--shape", "train_4k"])
    check(len(sizing) == 10 and all(r["status"] in ("ok", "does_not_fit")
                                    for r in sizing), "dryrun --shape train_4k")
    out = {"sizing": {r["arch"]: {"status": r["status"],
                                  "held_gb": r["held_bytes"] / 1e9} for r in sizing}}
    print(f"train_4k sizing: {time.perf_counter() - t0:.1f} s")
    out["flash_bwd"] = flash_bwd_4k(torch, flaunch, fbwd, fref, mem_rate)
    out["mlstm_bwd"] = mlstm_bwd_4k(torch, mlaunch, mbwd, mem_rate)
    out["slstm_bwd"] = slstm_bwd_4k(torch, mem_rate)
    out["card_vs_cpu"] = {name: train_4k_card_vs_cpu(torch, counted, name)
                          for name in TRAIN_4K_CPU}
    out["runs"] = {}
    for name, layers in TRAIN_4K_RUNS:
        t0 = time.perf_counter()
        out["runs"][name] = train_4k_run(torch, counted, name, layers)
        print(f"-- {name} x train_4k: {time.perf_counter() - t0:.1f} s", flush=True)
    check(all(out["runs"][n]["status"] == "ok" and out["runs"][n]["layers"] == full
              for n, full in (("hymba_1p5b", 32), ("xlstm_350m", 24))),
          "hymba-1.5b and xlstm-350m whole at train_4k")
    print("production training: " + json.dumps(
        {k: v for k, v in out.items() if k != "runs"}
        | {"runs": {n: {k: v for k, v in r.items() if k != "breakdown"}
                    for n, r in out["runs"].items()}}))
    return out


SHARDED_K = 4  # phase 18's sampled rounds


def sharded_training(torch, spec, counted) -> dict:
    """Phase 18: the sharded round (``federation_sharded.make_blendfl_
    round``) at full width on the card, fed by ``FederatedBatcher`` over
    phase 7's partition (its validation and test rows as the 2048-row
    validation set): 3 full-participation rounds through the prefetching
    stream (then one more under the profiler), 3 K = 4 async rounds
    under ``omega_ema`` (the synchronous path) and one K = 4 ``int8_topk``
    round. Every count is set to 0 just before each round and read just
    after it."""
    import dataclasses
    import gc

    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.federation_sharded import (batch_specs,
                                                     init_round_state,
                                                     make_blendfl_round)
    from repro_torch.core.schedule import telemetry_from_state
    from repro_torch.data.pipeline import FederatedBatcher
    from repro_torch.kernels.blendavg.blendavg import launches_for
    from repro_torch.launch.specs import blendfl_spec
    from repro_torch.launch.train_federated import client_arrays

    t0 = time.perf_counter()
    clients, va, te = training_data(spec)
    arrays = [client_arrays(c) for c in clients]
    val = {"val_a": np.concatenate([va.x_a, te.x_a]),
           "val_b": np.concatenate([va.x_b, te.x_b]),
           "val_y": np.concatenate([va.y, te.y])}
    # the reference's widest BlendFL entry (launch/specs.make_blendfl_entry)
    # with AdamW, over phase 7's partition
    base = dataclasses.replace(blendfl_spec(), optimizer="adamw")
    host_gb = sum(np.prod(shape) * dtype.itemsize for key, (shape, dtype)
                  in batch_specs(base, ragged=True).items()
                  if not key.startswith("val_")) / 1e9
    print(f"data {time.perf_counter() - t0:.2f} s; a full round's host batch "
          f"{host_gb:.2f} GB")
    out = {"runs": {}, "host_batch_gb": host_gb}
    totals = {name: 0 for name in counted}

    def drive(label, sspec, rounds, profile=False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batcher = FederatedBatcher(arrays, sspec, val, seed=0, prefetch=1,
                                   device="cuda")
        round_fn = make_blendfl_round(sspec)
        holder = {"state": init_round_state(torch.Generator().manual_seed(0),
                                            sspec, "cuda")}
        n_leaves = len(tree_leaves(holder["state"]["global_models"]))
        n_blends = sum(launches_for(n) for n in group_leaves(
            tree_leaves, holder["state"]["global_models"]).values())
        torch.cuda.synchronize()
        stream = batcher.rounds(0, rounds, telemetry_fn=lambda: telemetry_from_state(
            holder["state"]))
        rec = {"rounds": []}
        t_end = time.perf_counter()
        for r, batch in stream:
            t_batch = time.perf_counter()  # waited for, built, copied
            before = holder["state"]["last_round"].cpu().numpy()
            for m in counted.values():
                m.launches = 0
            holder["state"], metrics = round_fn(holder["state"], batch)
            torch.cuda.synchronize()
            t_round = time.perf_counter()
            got = {name: m.launches for name, m in counted.items()}
            for name, n in got.items():
                totals[name] += n
            losses = {k: float(metrics[k]) for k in
                      ("loss_uni", "loss_vfl", "loss_paired")}
            want = {name: 0 for name in counted}
            want["blend_params"] = n_blends  # every group blends, a tree a launch
            if sspec.codec != "none":
                want["wire_codec"] = 2 * n_leaves
            after = holder["state"]["last_round"].cpu().numpy()
            row = {"wall_s": t_round - t_end, "round_s": t_round - t_batch,
                   "batch_s": t_batch - t_end, "launches": got,
                   "losses": losses}
            msg = ""
            if sspec.n_sampled:
                ids = batch["sampled"].cpu().numpy()
                changed = np.flatnonzero(after != before)
                check(len(np.unique(ids)) == SHARDED_K, f"{label}: sampled {ids}")
                check(np.array_equal(changed, np.sort(ids)) and (after[ids] == r).all(),
                      f"{label} round {r}: last_round moved at {changed}, sampled {ids}")
                row["ids"] = ids.tolist()
                msg = f"; ids {ids.tolist()}"
            else:
                check((after == r).all(), f"{label}: last_round {after}")
            print(f"{label} round {r}: {row['wall_s']:.3f} s wall ({row['batch_s']:.3f} s "
                  f"waiting for and copying the batch, {row['round_s']:.3f} s the round)"
                  f"{msg}; losses { {k: round(v, 5) for k, v in losses.items()} }; "
                  f"omegas M {np.round(metrics['omega_M'].cpu().numpy(), 3).tolist()}; "
                  f"launches {got}")
            check(all(np.isfinite(v) for v in losses.values()), f"{label}: losses {losses}")
            check(got == want, f"{label} round {r}: launches {got}, want {want}")
            rec["rounds"].append(row)
            t_end = time.perf_counter()
        rec["build_s"] = batcher.build_seconds
        rec["stall_s"] = batcher.stall_seconds
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"{label}: batcher build {batcher.build_seconds:.3f} s over "
              f"{batcher.rounds_built} builds, stalled {batcher.stall_seconds:.3f} s; "
              f"peak device memory {rec['peak_gb']:.2f} GB")
        if profile:
            batch = batcher.put(batcher.build(rounds))
            torch.cuda.synchronize()
            walls = [r["round_s"] for r in rec["rounds"]]
            rec["breakdown"] = device_breakdown(
                lambda: round_fn(holder["state"], batch), float(np.median(walls)),
                top=8, match=("blend_kernel", "narrow_kernel", "hist_kernel",
                              "pass_kernel"))
            print_breakdown(f"{label}, a profiled round", rec["breakdown"])
        out["runs"][label] = rec
        del holder, batcher, stream

    drive("full", base, 3, profile=True)
    drive("K=4 omega_ema", dataclasses.replace(base, n_sampled=SHARDED_K,
                                               policy="omega_ema"), 3)
    drive("K=4 int8_topk", dataclasses.replace(base, n_sampled=SHARDED_K,
                                               codec="int8_topk"), 1)
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = totals
    return out


def cli_child(workdir: str) -> int:
    """Phase 19's child process (``chip_smoke.py --cli-child DIR``, started
    with ``CUBLAS_WORKSPACE_CONFIG`` set, so that the selftests' deterministic
    algorithms hold from its first cuBLAS call): the CLI's resume selftest
    on the Makefile's eight lanes, a full-width checkpointed run resumed by
    a second invocation, ``import`` and a store-backed run, then
    ``serve_federated --selftest`` on the checkpoint the port just wrote."""
    sys.path.insert(0, str(ROOT / "src"))
    import os

    from repro_torch.launch import serve_federated as sf
    from repro_torch.launch import train_federated as tf

    dev = ["--device", "cuda", "--log-every", "0"]
    small = ["--n-train", "384", "--rows-cap", "16", "--d-hidden", "16",
             "--n-val", "64"]
    k3 = ["--rounds", "4", "--clients", "6", "--n-sampled", "3"] + small
    lanes = [["--rounds", "2", "--clients", "4"] + small,
             k3 + ["--policy", "omega_ema"], k3 + ["--codec", "int8_topk"],
             k3 + ["--strategy", "scaffold"],
             k3 + ["--scenario", "examples/scenarios/ci_join.yaml"],
             k3 + ["--scenario", "examples/scenarios/ci_join.yaml",
                   "--codec", "int8_topk"],
             k3 + ["--scenario", "examples/scenarios/ci_join.yaml",
                   "--strategy", "scaffold"],
             k3 + ["--scenario", "examples/scenarios/ci_attack.yaml",
                   "--strategy", "trimmed_mean"]]
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG"), "CUBLAS_WORKSPACE_CONFIG unset")
    for lane in lanes:
        t0 = time.perf_counter()
        tf.main(["--selftest-resume"] + lane + dev)
        print(f"    lane {' '.join(lane)}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    full = ["--task", "conditions", "--clients", "16", "--d-hidden", "1024",
            "--n-layers", "4", "--rows-cap", "512", "--n-train", "16384"] + dev
    ckpt = os.path.join(workdir, "ckpt")
    t0 = time.perf_counter()
    first = tf.main(full + ["--rounds", "2", "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    # the resumed run checkpoints its last round, which the server reads
    second = tf.main(full + ["--rounds", "3", "--ckpt-dir", ckpt, "--ckpt-every", "1"])
    print(f"    checkpointed run: rounds {[r['round'] for r in first]} then, "
          f"resumed, {[r['round'] for r in second]} in "
          f"{time.perf_counter() - t0:.2f} s; launches a round "
          f"{[r['launches'] for r in first + second]}", flush=True)
    check([r["round"] for r in first] == [0, 1]
          and [r["round"] for r in second] == [2], "checkpointed run rounds")
    check(all(r["launches"] == {"blend_params": 3, "wire_codec": 0}
              for r in first + second), "checkpointed run launches")
    check(all(np.isfinite(r["loss_uni"]) for r in first + second), "losses")
    store = os.path.join(workdir, "store")
    tf.main(["import", "--store-dir", store, "--task", "conditions",
             "--clients", "16", "--n-train", "16384"])
    hist = tf.main(["--store-dir", store, "--rounds", "2"] + full[2:])
    check([r["round"] for r in hist] == [0, 1], "store-backed run rounds")
    sf.main(["--selftest", "--ckpt-dir", ckpt, "--task", "conditions",
             "--d-hidden", "1024", "--n-layers", "4", "--device", "cuda",
             "--requests", "32", "--rows", "8"])
    print("    served the port's checkpoint: serve_federated --selftest passed",
          flush=True)
    return 0


def cli_on_card() -> None:
    """Phase 19: ``cli_child`` in a child process with deterministic
    cuBLAS set before CUDA starts; its output is printed here."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--cli-child", workdir], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    keep = [ln for ln in lines if "resume parity OK" in ln or ln.startswith("    ")
            or "restored" in ln or "imported" in ln or "done (" in ln]
    print("\n".join(keep))
    check(proc.returncode == 0, f"the CLI child failed ({proc.returncode}):\n"
          + "\n".join(lines[-30:]) + proc.stderr[-3000:])
    check(sum("resume parity OK" in ln for ln in lines) == 8,
          "not every resume lane passed")


# Phase 20: the Makefile's sampled lanes, each with the data seed whose
# BlendAvg deltas (and compared omega EMAs) on the CPU lie at least
# DELTA_MARGIN from a tie (ROADMAP fault (d)): 5 for omega_ema, 4 for
# int8_topk. Each lane is "strict" (test_torch_federation.py's
# tolerances), "lossy" (params at the lossy run-level tolerance) or
# "ties". The int8_topk lane runs twice. With SGD at lr 0.1 it is held
# at the lossy tolerance. With the CLI's AdamW, the first step moves
# every entry by about +-lr, so most |deltas| lie within a few ulps of
# the top-k threshold and the card's and the CPU's last ulps keep
# different entries: omegas and params part from round 0 on. That lane
# holds what a tie cannot move (ids, round 0's losses, the counters, every
# uplink message through the codec kernel against its plain version on
# the card) and prints the rest, with the CPU's share of near-ties.
DELTA_MARGIN = 1e-3
CARD_CPU_LANES = (
    ("omega_ema", "strict", ["--policy", "omega_ema", "--data-seed", "5"]),
    ("int8_topk", "lossy", ["--codec", "int8_topk", "--optimizer", "sgd",
                            "--lr", "0.1", "--data-seed", "4"]),
    ("int8_topk_adamw", "ties", ["--codec", "int8_topk", "--data-seed", "4"]),
)


def near_tie_share(torch, msg, frac) -> float:
    """The share of a stacked message's top-k picks that lie within 1e-6
    (about 8 ulps) of their row's nonzero threshold: picks a last-ulp
    difference can swap."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.codec import topk_k

    near = kept = 0
    for x in tree_leaves(msg):
        a = x.reshape(x.shape[0], -1).abs()
        k = topk_k(a.shape[1], frac)
        thr = torch.topk(a, k, dim=1).values[:, -1:]
        near += int((((a - thr).abs() <= 1e-6 * thr) & (thr > 0)).sum())
        kept += a.shape[0] * k
    return near / kept


def sharded_card_vs_cpu(torch) -> dict:
    """Phase 20: the lanes of ``CARD_CPU_LANES`` (6 clients, K = 3) for 3
    rounds on the card and on the CPU from the same state (one seeded CPU
    generator draws it for both), each side selecting from its own
    telemetry. Every lane: ids equal, ``sched``'s counters and
    ``last_round`` equal, the CPU run's BlendAvg deltas and compared
    omega EMAs DELTA_MARGIN from a tie. "strict" and "lossy": losses rtol
    LOSS_RTOL, omegas and the omega EMA atol OMEGA_ATOL, global params
    rtol PARAM_RTOL / atol PARAM_ATOL ("lossy": at the lossy run-level
    tolerance). "ties": round 0's losses rtol LOSS_RTOL, and each card
    uplink message through the codec kernel against its plain version."""
    import repro_torch.core.federation_sharded as fs
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.convert import round_state_to_numpy
    from repro_torch.core.codec import topk_k
    from repro_torch.kernels.wire_codec import ops, ref
    from repro_torch.kernels.wire_codec import wire_codec as launcher
    from repro_torch.launch import train_federated as tf

    make_fns = fs.make_phase_fns
    margins, ties, held = [], [], []

    def recording(cfg):  # the CPU run: BlendAvg deltas, uplink near-ties
        fns = make_fns(cfg)
        update, uplink = fns.blendavg_update, fns.codec_uplink

        def blendavg_update(glob, cands, scores, gscore, **kw):
            margins.append(float((scores - gscore).abs().min()))
            return update(glob, cands, scores, gscore, **kw)

        def codec_uplink(trained, base, resid):
            msg = tree_map(lambda t, b, e: t - b + e, trained, base, resid)
            ties.append(near_tie_share(torch, msg, cfg.codec.topk_frac))
            return uplink(trained, base, resid)

        fns.blendavg_update, fns.codec_uplink = blendavg_update, codec_uplink
        return fns

    def checking(cfg):  # the card run: each uplink message kernel vs plain
        fns = make_fns(cfg)
        uplink = fns.codec_uplink

        def codec_uplink(trained, base, resid):
            msg = tree_map(lambda t, b, e: t - b + e, trained, base, resid)
            for x in tree_leaves(msg):
                flat = x.reshape(x.shape[0], -1)
                held.append(check_kernel(torch, ops, launcher, ref, flat,
                                         topk_k(flat.shape[1], cfg.codec.topk_frac),
                                         cfg.codec.quantize))
            return uplink(trained, base, resid)

        fns.codec_uplink = codec_uplink
        return fns

    worst = {}
    for label, mode, flags in CARD_CPU_LANES:
        runs, emas = {}, []
        margins.clear(), ties.clear(), held.clear()
        for dev in ("cuda", "cpu"):
            fs.make_phase_fns = {"cpu": recording, "cuda": checking if mode == "ties"
                                 else make_fns}[dev]
            args = tf.parse_args(["--rounds", "3", "--clients", "6", "--n-sampled",
                                  "3", "--n-train", "384", "--rows-cap", "16",
                                  "--d-hidden", "16", "--n-val", "64",
                                  "--log-every", "0", "--device", dev] + flags)
            spec, batcher, round_fn, device = tf.build_federation(args)
            _, state = tf.init_or_restore(args, spec, device)
            rows = []
            for r in range(3):
                sched = (tf.telemetry_from_state(state)
                         if batcher.policy.needs_state else None)
                if sched is not None and dev == "cpu":
                    emas.append(sched["omega_ema"])
                batch = batcher.put(batcher.build(r, sched))
                state, m = round_fn(state, batch)
                rows.append(({k: v.cpu().numpy() for k, v in m.items()},
                             batch["sampled"].cpu().numpy()))
            runs[dev] = (rows, round_state_to_numpy(state))
        fs.make_phase_fns = make_fns
        w = {"loss": 0.0, "omega": 0.0, "smallest delta": min(margins)}
        check(min(margins) >= DELTA_MARGIN,
              f"{label}: a CPU BlendAvg delta {min(margins)} lies within "
              f"{DELTA_MARGIN} of a tie")
        for ema in emas:
            gaps = np.abs(ema[:, None] - ema[None, :])
            check(bool(np.all((gaps == 0) | (gaps >= DELTA_MARGIN))),
                  f"{label}: compared omega EMAs within {DELTA_MARGIN}: {ema}")
        for r, ((card, ids_c), (cpu, ids_h)) in enumerate(zip(runs["cuda"][0],
                                                              runs["cpu"][0])):
            check(np.array_equal(ids_c, ids_h), f"{label}: ids {ids_c} vs {ids_h}")
            for k in ("loss_uni", "loss_vfl", "loss_paired"):
                check(np.isfinite(float(card[k])), f"{label} {k}: card {card[k]}")
                rel = abs(float(card[k]) - float(cpu[k])) / abs(float(cpu[k]))
                w["loss"] = max(w["loss"], rel)
                if mode != "ties" or r == 0:
                    check(rel <= LOSS_RTOL, f"{label} round {r} {k}: card "
                          f"{card[k]} cpu {cpu[k]}")
            for k in ("omega_A", "omega_B", "omega_M"):
                d = float(np.abs(card[k] - cpu[k]).max())
                w["omega"] = max(w["omega"], d)
                if mode != "ties":
                    check(d <= OMEGA_ATOL, f"{label} {k}: card {card[k]} cpu {cpu[k]}")
        (_, sc), (_, sh) = runs["cuda"], runs["cpu"]
        a, b = tree_leaves(sc["global_models"]), tree_leaves(sh["global_models"])
        check(all(np.isfinite(x).all() for x in a), f"{label}: card params not finite")
        d = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
        w["params"] = float(d.max())
        if mode != "strict":
            w["params share within atol"] = float((d <= PARAM_ATOL).mean())
        if mode == "lossy":
            check(d.max() <= LOSSY_MAX_ABS and (d <= PARAM_ATOL).mean() >= LOSSY_SHARE,
                  f"{label}: params card vs CPU max {d.max()}")
        elif mode == "strict":
            check(all(np.allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
                      for x, y in zip(a, b)), f"{label}: params card vs CPU")
        for k in ("part_count", "last_round"):
            check(np.array_equal(sc["sched"][k], sh["sched"][k]), f"{label}: sched {k}")
        check(np.array_equal(sc["last_round"], sh["last_round"]), f"{label}: last_round")
        w["omega_ema"] = float(np.abs(sc["sched"]["omega_ema"]
                                      - sh["sched"]["omega_ema"]).max())
        if mode != "ties":
            check(w["omega_ema"] <= OMEGA_ATOL, f"{label}: omega_ema")
        if ties:
            w["uplink near-tie share by round"] = [float(f"{t:.4g}") for t in ties]
        if held:
            w["uplink messages kernel vs plain"] = len(held)
            w["uplink kernel max abs err"] = max(held)
        print(f"card vs CPU, sharded round, {label} lane ({mode}), 3 rounds: "
              f"{ {k: v if isinstance(v, (list, int)) else float(f'{v:.4g}') for k, v in w.items()} }"
              f"; ids {[ids.tolist() for _, ids in runs['cuda'][0]]}")
        worst[label] = w
    return worst


# Phase 21: the paper's baselines (core/baselines.py) at full width, then
# four of them card against CPU at phase 8's width.
BASELINE_ORDER = ("fedavg", "fedprox", "fednova", "fedma", "hfcl", "splitnn",
                  "oneshot_vfl", "centralized")
BASELINE_KEYS = ("multimodal_auroc", "uni_a_auroc", "uni_b_auroc",
                 "multimodal_auprc", "uni_a_auprc", "uni_b_auprc")
BASELINES_CARD_CPU = ("fedavg", "fednova", "splitnn", "oneshot_vfl")
# the baselines on the variant encoders run on the first 4 of phase 7's
# 16 clients (a cut of scale: widths as phase 22's)
BASELINE_VARIANT_CLIENTS = 4


def greedy_match_numpy(ref, cand):
    """A numpy copy of the reference's FedMA matcher
    (``src/repro/core/baselines.py:270-283``), which this script may not
    import: n argmax passes over the similarity matrix with the rows
    already matched and the columns already used at -inf. The reference
    builds that masked matrix anew each pass with two ``np.where``; here
    the picked row and column are set to -inf in one copy of ``sim``,
    which gives the same matrix at every pass (``sim`` is finite), so
    the same first maximal index, without two (n, n) temporaries a pass
    (phase 21 runs five (1024, 1024) matchings; the reference's form took
    3.07 s each on the card's host)."""
    n = ref.shape[0]
    sim = (ref / (np.linalg.norm(ref, axis=1, keepdims=True) + 1e-9)) @ (
        cand / (np.linalg.norm(cand, axis=1, keepdims=True) + 1e-9)).T
    check(bool(np.isfinite(sim).all()), "FedMA similarity not finite")
    masked = np.array(sim)
    perm = np.full(n, -1)
    for _ in range(n):
        i, j = np.unravel_index(np.argmax(masked), sim.shape)
        perm[i] = j
        masked[i, :] = -np.inf
        masked[:, j] = -np.inf
    return perm


def baseline_blends(name, clients, tree_leaves_by_key, rounds) -> int:
    """Blend launches a baseline makes: one a model tree it blends
    (``launches_for`` its leaves: one up to 64), f_A and g_A, f_B and
    g_B, g_M, of each group with members, every round of the HFL
    baselines (HFCL's pooled client holds a modality iff a data-sharing
    client does, so its groups are those of all clients); One-Shot VFL
    blends f and g of A and B once; SplitNN and centralized none."""
    from repro_torch.kernels.blendavg.blendavg import launches_for

    has = {"A": any(c.has_a for c in clients), "B": any(c.has_b for c in clients),
           "M": any(c.has_paired for c in clients)}
    trees = {"A": ("f_A", "g_A"), "B": ("f_B", "g_B"), "M": ("g_M",)}

    def per(groups):
        return sum(launches_for(tree_leaves_by_key[k]) for m in groups if has[m]
                   for k in trees[m])

    if name in ("splitnn", "centralized"):
        return 0
    if name == "oneshot_vfl":
        return per("AB")
    return rounds * per("ABM")


def baselines_phase(torch, spec, ecfg, data, blaunch, bref) -> dict:
    """Phase 21: each of the eight baselines once at full width on phase
    7's data (16 clients, 1 round of 1 local epoch, lr 1e-2, batch 64):
    wall s, blend launches (set to 0 just before each run, read just
    after, against ``baseline_blends``), peak memory and the six metrics
    (each NaN or in [0, 1]); FedAvg's blends held against the plain
    version within ``blend_error_bound``; FedMA's matching seconds and one
    (1024, 1024) hidden-layer matching against ``greedy_match_numpy``;
    the first matched member with every hidden layer's units shuffled,
    through ``_match_encoder`` on the card, against the numpy loop's
    ``w[:, perm]`` / ``b[perm]``; SplitNN timed again and profiled. Then FedAvg, FedNova, SplitNN and One-Shot VFL at phase 8's width on
    the card and on the CPU from the same weights: final models at
    PARAM_RTOL / PARAM_ATOL, metrics within EVAL_ATOL."""
    import repro_torch.core.baselines as bl
    from repro_torch.common.tree import tree_leaves
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.encoders import EncoderConfig, init_client_models
    from repro_torch.core.federation import FedConfig
    from repro_torch.core.partitioner import partition
    from repro_torch.data.synthetic import make_task, train_val_test

    t_phase = time.perf_counter()
    clients, va, te = data
    cfg = FedConfig(n_clients=16, rounds=1, local_epochs=1, lr=1e-2, batch_size=64)
    models = init_client_models(torch.Generator().manual_seed(0), spec, ecfg,
                                device="cpu")
    leaves = group_leaves(tree_leaves, models)
    check(leaves == {"A": 13, "B": 13, "M": 4}, f"leaves per group {leaves}")
    key_leaves = {k: len(tree_leaves(v)) for k, v in models.items()}
    del models
    blend_trees, greedy, match_encoder = bl.blend_trees, bl._greedy_match, bl._match_encoder
    captured, matches = [], {"n": 0, "s": 0.0, "first": None, "member": None}

    def capture(trees, omega):  # FedAvg's blends, held against plain below
        out = blend_trees(trees, omega)
        captured.append(([tree_leaves(t) for t in trees], omega, tree_leaves(out)))
        return out

    def timed_match(ref, cand, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perm = greedy(ref, cand, device=device)
        torch.cuda.synchronize()
        matches["s"] += time.perf_counter() - t0
        matches["n"] += 1
        if matches["first"] is None:  # host copies FedMA made for this call
            matches["first"] = (ref, cand, perm.cpu().numpy())
        return perm

    def kept_match(ref_ws, f):  # the first member FedMA matches, as given
        if matches["member"] is None:
            matches["member"] = (ref_ws, f)
        return match_encoder(ref_ws, f)

    runs = {}
    for name in BASELINE_ORDER:
        bl.blend_trees = capture if name == "fedavg" else blend_trees
        bl._greedy_match = timed_match if name == "fedma" else greedy
        bl._match_encoder = kept_match if name == "fedma" else match_encoder
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        blaunch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res, _ = bl.BASELINES[name](torch.Generator().manual_seed(0), spec,
                                        ecfg, clients, va, te, cfg, device="cuda")
        finally:
            bl.blend_trees, bl._greedy_match = blend_trees, greedy
            bl._match_encoder = match_encoder
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = blaunch.launches, baseline_blends(name, clients, key_leaves,
                                                      cfg.rounds)
        runs[name] = {"wall_s": wall, "blend_launches": got,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "metrics": res}
        print(f"{name}: {wall:.3f} s wall; {got} blend launches (want {want}); "
              f"peak memory {runs[name]['peak_gb']:.2f} GB; "
              f"{ {k: round(v, 4) for k, v in res.items()} }")
        check(sorted(res) == sorted(BASELINE_KEYS), f"{name}: metric keys {sorted(res)}")
        check(all(np.isnan(v) or 0.0 <= v <= 1.0 for v in res.values()),
              f"{name}: metrics {res}")
        check(got == want, f"{name}: {got} blend launches, want {want}")

    err = 0.0
    for trees, omega, out in captured:
        om = torch.as_tensor(np.asarray(omega, np.float32), device=out[0].device)
        for i, g in enumerate(out):
            flat = torch.stack([t[i] for t in trees]).reshape(len(trees), -1)
            want = bref.blend_params_ref(flat, om)
            e = (g.reshape(-1) - want).abs()
            check(bool((e <= bref.blend_error_bound(flat, om, want, g.reshape(-1))).all()),
                  "FedAvg's blend beyond its bound against the plain version")
            err = max(err, float(e.max()))
    check(len(captured) == 5, f"FedAvg blended {len(captured)} trees, want 5")
    print(f"FedAvg's {sum(len(o) for _, _, o in captured)} blended leaves match "
          f"the plain version on the card; max abs err {err:.3g}")
    del captured

    ref, cand, perm = matches["first"]
    t0 = time.perf_counter()
    want = greedy_match_numpy(ref, cand)
    numpy_s = time.perf_counter() - t0
    n = ecfg.d_hidden
    check(ref.shape == (n, n), f"first FedMA matching at {ref.shape}")
    check(np.array_equal(perm, want), "FedMA's permutation on the card differs "
          "from the reference loop's")
    # the first matched member with every hidden layer's units shuffled
    # (its members start from one global, so as run each matching is the
    # identity): _match_encoder must move every unit back on the card
    ref_ws, member = matches["member"]
    rng = np.random.default_rng(21)
    shuffled = dict(member, hidden=[])
    for layer in member["hidden"]:
        shuf = torch.as_tensor(rng.permutation(n), device=layer["w"].device)
        shuffled["hidden"].append({"w": layer["w"][:, shuf], "b": layer["b"][shuf]})
    out = bl._match_encoder(ref_ws, shuffled)
    moved = 0
    for ref_w, src, got in zip(ref_ws, shuffled["hidden"], out["hidden"]):
        w, b = src["w"].cpu().numpy(), src["b"].cpu().numpy()
        want_p = greedy_match_numpy(ref_w.T, w.T)
        moved += int((want_p != np.arange(n)).sum())
        check(got["w"].is_cuda and np.array_equal(got["w"].cpu().numpy(), w[:, want_p])
              and np.array_equal(got["b"].cpu().numpy(), b[want_p]),
              "FedMA's _match_encoder of a shuffled member on the card differs "
              "from the reference loop's permutation")
    print(f"FedMA: {matches['n']} matchings in {matches['s']:.3f} s on the card "
          f"({matches['s'] / max(matches['n'], 1) * 1e3:.2f} ms each); the first "
          f"({n} x {n}) equals the numpy reference loop's permutation "
          f"({numpy_s:.2f} s on the host; {int((perm != np.arange(n)).sum())} "
          f"units moved); a member with its {len(ref_ws)} hidden layers shuffled, "
          f"matched by _match_encoder on the card, equals the loop's "
          f"w[:, perm] / b[perm] ({moved} units moved)")

    # where the time goes: an HFL baseline and SplitNN again (a first run
    # pays one-time costs, such as the import autograd makes for the
    # first grad_outputs), then under the profiler
    for name in ("splitnn",):
        def again(name=name):
            return bl.BASELINES[name](torch.Generator().manual_seed(0), spec, ecfg,
                                      clients, va, te, cfg, device="cuda")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again()
        torch.cuda.synchronize()
        runs[name]["warm_wall_s"] = time.perf_counter() - t0
        bd = device_breakdown(again, runs[name]["warm_wall_s"])
        runs[name]["breakdown"] = bd
        print(f"{name} again: {bd['wall_ms']:.2f} ms wall; profiled: device busy "
              f"{bd['busy_ms']:.2f} ms, idle share {bd['idle_share']:.3f}")
        for k in bd["top"]:
            print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x {k['kernel']}")

    # card against CPU at phase 8's width
    small = make_task("smnist")
    tr, va8, te8 = train_val_test(small, 500, 300, 300, seed=0)
    cl8 = partition(tr, 3, frac_paired=0.4, frac_fragmented=0.3, frac_partial=0.3)
    cfg8 = FedConfig(n_clients=3, rounds=2, lr=1e-2, batch_size=64)
    ecfg8 = EncoderConfig(d_hidden=48, n_layers=2)
    evaluate = bl._evaluate
    worst = {}
    for name in BASELINES_CARD_CPU:
        side = {}
        for dev in ("cuda", "cpu"):
            seen = []

            def recording(models, *a, **k):
                seen.append(params_to_numpy(models))
                return evaluate(models, *a, **k)

            bl._evaluate = recording
            try:
                res, _ = bl.BASELINES[name](torch.Generator().manual_seed(0), small,
                                            ecfg8, cl8, va8, te8, cfg8, device=dev)
            finally:
                bl._evaluate = evaluate
            side[dev] = (res, seen[-1])
        (rc, mc), (rp, mp) = side["cuda"], side["cpu"]
        pairs = list(zip(tree_leaves(mc), tree_leaves(mp)))
        d_par = max(float(np.abs(a - b).max()) for a, b in pairs)
        d_met = max(abs(rc[k] - rp[k]) for k in rp)
        worst[name] = {"params": d_par, "metrics": d_met}
        print(f"{name} card vs CPU: params max abs {d_par:.3g}, metrics max abs "
              f"{d_met:.3g}")
        check(all(np.allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL) for a, b in pairs),
              f"{name}: card vs CPU params beyond tolerance")
        check(d_met <= EVAL_ATOL, f"{name}: card {rc} cpu {rp}")
    secs = time.perf_counter() - t_phase
    print(f"baselines phase: {secs:.1f} s")
    return {"runs": runs, "fedma_match_s": matches["s"],
            "fedma_matches": matches["n"], "blend_err": err,
            "card_vs_cpu": worst, "seconds": secs}


# Phase 22: the recurrent and transformer encoders trained at full width.
# Per encoder type: its forward kernel's module name, its backward's, and
# the backward's launches for one stacked encoder application (S = 64:
# the sLSTM's one, the flash backward's fused kernel,
# flash_attention_bwd.kernels_a_call(64, 64)).
VARIANT_KERNELS = {"recurrent": ("slstm_cell", "slstm_cell_bwd", 1),
                   "transformer": ("flash_attention", "flash_attention_bwd", 1)}
# Kernel names (as the profiler reports them) of each encoder type's
# forward and backward kernels.
VARIANT_SYMBOLS = {"recurrent": ("slstm_kernel", "slstm_bwd_kernel"),
                   "transformer": ("flash_kernel", "fused_kernel")}
# The backward kernels' names, for their device time.
FLASH_BWD_SYMBOLS = ("fused_kernel", "dq_kernel", "dkv_kernel")


def count_applications(targets):
    """Count the calls of each (module, function name, key) in
    ``targets`` by wrapping it where the round looks it up. Returns
    (counts by key, a function that undoes the wrapping)."""
    counts = {key: 0 for _, _, key in targets}
    undo = []
    for mod, name, key in targets:
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _key=key, **k):
            counts[_key] += 1
            return _orig(*a, **k)

        setattr(mod, name, wrapped)
        undo.append((mod, name, orig))

    def restore():
        for mod, name, orig in undo:
            setattr(mod, name, orig)

    return counts, restore


def slstm_bwd_inputs(torch, slaunch, sref, rows, clients, seed):
    """The backward's inputs at the encoder's width (4 heads of 256, 64
    steps): the saving forward kernel's gate sums and states for random
    pre-activations and C clients' recurrent weights, stacked as training
    stacks them, and a random output gradient. The forward's output and
    saved tensors are first held against the plain forward's on the same
    inputs within ``slstm_error_bound``. Returns (saved, r, dhs, the
    forward's max abs error)."""
    h, s, hd = 4, 64, 256
    gen = np.random.default_rng(seed)
    pre = torch.from_numpy(gen.standard_normal((rows, h, s, 4, hd), np.float32)
                           * 0.5).cuda()
    r = torch.from_numpy(gen.standard_normal((clients, h, hd, 4 * hd), np.float32)
                         / np.float32(np.sqrt(hd))).cuda()
    out, saved = slaunch.slstm_cell_cuda(pre, r, save=True)
    err = 0.0
    for name, got, want in zip(("output", "saved"), (out, saved),
                               sref.slstm_cell_ref(pre, r, save=True)):
        e = (got - want).abs()
        check(bool((e <= sref.slstm_error_bound(want, got)).all()),
              f"slstm_cell saving forward's {name} at {rows} rows of {clients} "
              f"clients beyond its bound: max err {float(e.max())}")
        err = max(err, float(e.max()))
    del pre, out
    dhs = torch.from_numpy(gen.standard_normal((rows, h, s, hd), np.float32)).cuda()
    return saved, r, dhs, err


def slstm_bwd_bound_ms(rows, clients, h, s, hd, mem_rate):
    """The larger of: the saved gate sums and state (7 floats) and the
    output gradient read once, the pre-activations' gradient (4 floats)
    written once, r read once, over the memory rate; and the recurrent
    products' 2*hd*4hd f32 operations a step and (row, head), as in the
    forward, on the engine the kernel runs them on: 3xTF32 on the tensor
    cores (three TF32 products for each f32 one, 495 TFLOP/s)."""
    nbytes = rows * h * s * hd * 12 * 4 + clients * h * hd * 4 * hd * 4
    ops = rows * h * s * 2 * hd * 4 * hd
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / (TF32_OPS_PER_S / 3) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def flash_bwd_bound_ms(bh, s, d, mem_rate):
    """The larger of: q, k, v, out, dout and the row log-sum-exp read once
    and dq, dk, dv written once, over the memory rate; and the five
    products' 2 * S^2 * d operations each a (batch, head) on the engine
    the kernel runs them on: at S <= 64 the fused kernel's 3xTF32 on the
    tensor cores (three TF32 products for each f32 one, 495 TFLOP/s),
    above it the two SIMT kernels' f32 (67 TFLOP/s)."""
    nbytes = bh * s * (8 * d + 1) * 4
    ops = bh * 10 * s * s * d
    rate = TF32_OPS_PER_S / 3 if s <= 64 else FP32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def backward_kernels(torch, mem_rate) -> dict:
    """Each backward kernel against its plain backward on the same inputs,
    on one client's slice at full width (64 rows, 4 heads of 256, S = 64)
    and at a round's stacked shape (16 clients, 1024 rows), within
    ``slstm_grad_error_bound`` / ``flash_grad_error_bound``; then timed at
    the stacked shape beside the plain backward, the bound and, for
    attention, the library's backward (SDPA's memory-efficient kernel).
    The forwards that training runs, the saving sLSTM and flash with the
    log-sum-exp, are held against their plain versions at both shapes
    first, since both backwards read what they give."""
    from repro_torch.kernels.flash_attention import flash_attention as flaunch
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.slstm_cell import ref as sref
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as sbwd

    out = {}
    errs, fwd_errs = [], {}
    for rows, clients in ((64, 1), (1024, 16)):
        saved, r, dhs, fwd_errs[f"slstm_cell {rows}"] = slstm_bwd_inputs(
            torch, slaunch, sref, rows, clients, seed=rows)
        got = sbwd.slstm_cell_bwd_cuda(saved, r, dhs)
        want = sref.slstm_cell_bwd_ref(saved, r, dhs)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all())
              and bool((err <= sref.slstm_grad_error_bound(want)).all()),
              f"slstm_cell_bwd at {rows} rows beyond its bound: max err "
              f"{float(err.max())}")
        errs.append(float(err.max()))
        del got, want, err
    plan, budget, active = sbwd.kernel_plan(64, 16 * 4, 256)
    check(plan == sbwd.plan(64, 16 * 4, 256, budget) and active >= 1,
          f"slstm_cell_bwd plan at 16 clients x 64 rows: the kernel's {plan}, "
          f"budget {budget}, active {active}")
    clusters = 16 * 4 * plan.groups
    print(f"slstm_cell_bwd plan at (1024, 4, 64, 256), 16 clients: {clusters} "
          f"clusters of {plan.cluster} CTAs, {plan.rows} rows and "
          f"{plan.units} units a CTA, {plan.smem} bytes of shared memory; the "
          f"card holds {active} at once (budget {budget}): "
          f"{clusters / active:.2f} waves")
    ms = cuda_time_ms(lambda: sbwd.slstm_cell_bwd_cuda(saved, r, dhs), iters=10,
                      warmup=2)
    plain_ms = cuda_time_ms(lambda: sref.slstm_cell_bwd_ref(saved, r, dhs),
                            iters=3, warmup=1)
    bound, by = slstm_bwd_bound_ms(1024, 16, 4, 64, 256, mem_rate)
    out["slstm_cell_bwd"] = {
        "shape": [1024, 4, 64, 256], "clients": 16, "ms": ms, "plain_ms": plain_ms,
        "device_ms": counted_ms(lambda: sbwd.slstm_cell_bwd_cuda(saved, r, dhs),
                                iters=5, label="slstm_cell_bwd", launcher=sbwd,
                                symbols=("slstm_bwd_kernel",)),
        "bound_ms": bound, "bound_by": by, "max_abs_err": max(errs),
        "max_abs_err_by_rows": {"64": errs[0], "1024": errs[1]},
        "plan": {"clusters": clusters, "cluster": plan.cluster, "rows": plan.rows,
                 "smem": plan.smem, "active": active,
                 "waves": clusters / active},
        "library_ms": None}
    del saved, r, dhs
    torch.cuda.empty_cache()

    errs = []
    for bh in (64, 1024):
        gen = np.random.default_rng(bh)
        q, k, v, dout = (torch.from_numpy(gen.standard_normal(
            (bh, 4, 64, 256), np.float32)).cuda() for _ in range(4))
        o, lse = flaunch.flash_attention_cuda(q, k, v, causal=False, window=0,
                                              return_lse=True)
        fwd_err = 0.0
        for name, g, w in zip(("output", "lse"), (o, lse), fref.flash_attention_ref(
                q, k, v, causal=False, return_lse=True)):
            err = (g - w).abs()
            tol = fref.TOL[torch.float32]
            check(bool((err <= tol + tol * w.abs()).all()),
                  f"flash_attention's {name} at ({bh}, 4, 64, 256) beyond its "
                  f"tolerance: max err {float(err.max())}")
            fwd_err = max(fwd_err, float(err.max()))
        fwd_errs[f"flash_attention {bh}"] = fwd_err
        got = fbwd.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=False)
        want = fref.flash_attention_bwd_ref(q, k, v, o, dout, lse, causal=False)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g - w).abs()
            check(bool(torch.isfinite(g).all())
                  and bool((err <= fref.flash_grad_error_bound(w)).all()),
                  f"flash_attention_bwd {name} at ({bh}, 4, 64, 256) beyond its "
                  f"bound: max err {float(err.max())}")
            errs.append(float(err.max()))
        del got, want

    def kern():
        return fbwd.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=False)

    def plain():
        return fref.flash_attention_bwd_ref(q, k, v, o, dout, lse, causal=False)

    # the library yardstick, timed here and never on the path: SDPA's
    # memory-efficient backward (its one op, run again on a kept graph)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lo = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
    check("EfficientAttention" in lo.grad_fn.name(),
          f"SDPA took {lo.grad_fn.name()}, not the memory-efficient kernel")

    def library():
        return torch.autograd.grad(lo, (qg, kg, vg), dout, retain_graph=True)

    lib_err = max(float((g - w).abs().max()) for g, w in zip(library(), plain()))
    bound, by = flash_bwd_bound_ms(1024 * 4, 64, 256, mem_rate)
    out["flash_attention_bwd"] = {
        "shape": [1024, 4, 64, 256], "clients": 16, "ms": cuda_time_ms(kern, iters=20),
        "plain_ms": cuda_time_ms(plain, iters=10),
        "device_ms": counted_ms(kern, iters=10, label="flash_attention_bwd",
                                launcher=fbwd, symbols=FLASH_BWD_SYMBOLS),
        "bound_ms": bound, "bound_by": by, "max_abs_err": max(errs),
        "library_ms": cuda_time_ms(library, iters=20),
        "library_device_ms": counted_ms(library, iters=10,
                                        label="SDPA efficient backward"),
        "library_max_abs_err": lib_err}
    for name, t in out.items():
        print(f"{name} {t['shape']}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']} ms), plain {t['plain_ms']:.4f} ms; library "
              f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)}"
              f" ms (device {t.get('library_device_ms')} ms, max abs diff to "
              f"plain {t.get('library_max_abs_err')}); bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); max abs err {t['max_abs_err']:.3g}")
    print(f"training forwards against plain, max abs err: {fwd_errs}")
    out["forward_errs"] = fwd_errs
    return out


def variant_training(torch, spec, data, counted) -> dict:
    """Phase 22: one full-width BlendAvg round of 16 clients (phase 7's
    data; d_hidden 1024, 4 heads of 256) on each of the recurrent and
    transformer encoders: round wall, peak memory, finite losses, the
    launch counts (one forward launch a stacked encoder application in
    training and one an application in scoring; one sLSTM backward, or
    one fused flash backward, a stacked application; the blends of phase
    7; no other kernel), a profiled round (busy, idle share, the kernels
    that take most) and ``evaluate_global``."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core import engine as eng_mod
    from repro_torch.core import federation as fed_mod
    from repro_torch.core.encoders import EncoderConfig
    from repro_torch.core.federation import FedConfig, Federation, evaluate_global

    clients, va, te = data
    blaunch = counted["blend_params"]
    runs = {}
    for enc_type, (fwd, bwd, per) in VARIANT_KERNELS.items():
        ecfg = EncoderConfig(d_hidden=1024, n_layers=4, enc_type=enc_type,
                             n_heads=4)
        cfg = FedConfig(n_clients=16, rounds=1, lr=1e-2, batch_size=64)
        fed = Federation.init(torch.Generator().manual_seed(0), cfg, spec, ecfg,
                              clients, va, device="cuda")
        leaves = group_leaves(tree_leaves, fed.global_models)
        counts, restore = count_applications([
            (eng_mod, "encoder_apply_stacked", "stacked"),
            (eng_mod, "encoder_apply", "apply"),
            (fed_mod, "encoder_apply", "apply")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in counted.values():
            m.launches = 0
        t0 = time.perf_counter()
        try:
            logs = fed.round()
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t0
        got = {name: m.launches for name, m in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        want = {name: 0 for name in counted}
        want[fwd] = counts["stacked"] + counts["apply"]
        want[bwd] = per * counts["stacked"]
        want["blend_params"] = sum(blaunch.launches_for(leaves[m])
                                   for m in blended(logs))
        losses = {k: logs[k] for k in ("loss_partial", "loss_vfl", "loss_paired")}
        print(f"{enc_type}: round {wall:.3f} s wall, peak memory "
              f"{peak / 1e9:.2f} GB; losses "
              f"{ {k: round(v, 5) for k, v in losses.items()} }; "
              f"{counts['stacked']} stacked encoder applications (training), "
              f"{counts['apply']} unstacked (scoring); launches {got}")
        check(counts["stacked"] > 0 and got[fwd] > 0 and got[bwd] > 0,
              f"{enc_type} round: no training through its kernels: {got}")
        check(got == want, f"{enc_type} round: launches {got}, want {want}")
        check(all(np.isfinite(v) for v in losses.values()),
              f"{enc_type} round: losses {losses}")
        bd = device_breakdown(lambda: fed.round(), wall,
                              match=VARIANT_SYMBOLS[enc_type] + ("blend_kernel",))
        print_breakdown(f"{enc_type} training round", bd)
        ev = evaluate_global(fed, te)
        check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in ev.values()),
              f"{enc_type} evaluate_global {ev}")
        runs[enc_type] = {"round_wall_s": wall, "peak_memory_gb": peak / 1e9,
                          "launches": got, "applications": dict(counts),
                          "losses": losses, "breakdown": bd,
                          "evaluate_global": ev}
        del fed
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------ LM training (15a) --

# Phase 26: the mLSTM-scan backward kernel against the plain backward,
# (B, H, S, dk, dv, normalize): two chunks and a ragged tail, one ragged
# chunk, three column blocks (the last ragged); then the two it is timed
# at: xlstm-350m's training shape (8 x 128 tokens, 4 heads of 512) and
# hymba's Mamba heads (2 x 2048 tokens, 25 heads, dk 16, dv 64, no
# normalizer).
MLSTM_BWD_CASES = ((1, 2, 150, 64, 64, True), (1, 2, 150, 64, 64, False),
                   (2, 3, 37, 16, 24, True), (1, 1, 70, 8, 130, True))
MLSTM_BWD_XLSTM = (8, 4, 128, 512, 512, True)
MLSTM_BWD_HYMBA = (2, 25, 2048, 16, 64, False)
# Phase 27: launch/train.py at full width, its reference
# defaults' shape (8 x 128 tokens), 20 steps with --ckpt-every 12, so one
# checkpoint, at step 12 (a second at step 20, written and removed, took
# about 6.5 s and 4.86 GB of disk), then the run resumed from step 12.
# The kernels a step launches at one
# microbatch: one forward and one backward of each cell a layer pair.
# Its depth: the first XLSTM_TRAIN_LAYERS of the 24 layers (4 of the 12
# pairs; at all 24 the phase took 43-51 s of the run's limit, 4.86 GB a
# checkpoint written and read back).
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BATCH, TRAIN_SEQ = 20, 12, 8, 128
XLSTM_TRAIN_LAYERS = 8
TRAIN_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
                  "mlstm_scan": 4, "mlstm_scan_bwd": 4, "slstm_cell": 4,
                  "slstm_cell_bwd": 4}
# Phase 30: hymba-1.5b the same way at full width (d 1600) and the first
# HYMBA_LAYERS of its 32 layers (at all 32 the phase took 151 s of the
# run's limit, 17 GB a checkpoint written and read back), 2 x 2048 tokens
# (its window of 1024 binds), 12 steps with one checkpoint (parameters
# and two moments), at step 8, then resumed from it. A step launches the flash
# forward and the mLSTM scan (the Mamba heads) once a layer, and their
# backwards once a layer: kernels_a_call(2048, 2048, 5) = 2 flash
# backward kernels, counted each, and one mLSTM backward call of
# mlstm_scan_bwd.LAUNCHES = 5 launches, counted once
# (``train_launches``).
HYMBA_STEPS, HYMBA_CKPT_EVERY, HYMBA_BATCH, HYMBA_SEQ = 12, 8, 2, 2048
HYMBA_LAYERS = 4
TRAIN_RUNS = {
    "xlstm-350m": dict(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       layers=XLSTM_TRAIN_LAYERS,
                       match=("mlstm_kernel", "mlstm_bwd", "slstm_kernel",
                              "slstm_bwd_kernel", "gemm")),
    "hymba-1.5b": dict(steps=HYMBA_STEPS, ckpt_every=HYMBA_CKPT_EVERY,
                       batch=HYMBA_BATCH, seq=HYMBA_SEQ, layers=HYMBA_LAYERS,
                       match=("flash_kernel", "dq_kernel", "dkv_kernel",
                              "mlstm_kernel", "mlstm_bwd", "gemm")),
}

# Phase 28: training card against CPU, 1 of xlstm-350m's 12 layer pairs
# at full width, 2 x 128 tokens, 3 steps of the CLI's AdamW. Gradients
# and the moments (sums of gradients) within TRAIN_GRAD_REL of each
# leaf's largest |value|: f32 sums in other orders (cuBLAS against the
# CPU's GEMMs at K = 1024-4096, the kernels' chunkwise and 3xTF32 sums
# against the plain step recurrences), through 2 layers and back, as
# LM_CPU_TOL holds the logits. Parameters within ADAM_STEP_BOUND times
# the summed learning rates: AdamW divides by sqrt(v) + 1e-8, so an
# entry whose gradient lies within that noise of 0 takes a step whose
# sign the noise decides, and in the first steps |m^ / sqrt(v^)| is at
# most 1.01 (by Cauchy-Schwarz over the bias-corrected weights).
TRAIN_CPU_LAYERS = 2
TRAIN_GRAD_REL = 1e-3
ADAM_STEP_BOUND = 2.02


def train_args(arch: str) -> list:
    """The CLI's arguments of TRAIN_RUNS[arch], at full width and its
    depth (all its layers, or the first ``layers``)."""
    run = TRAIN_RUNS[arch]
    return (["--arch", arch, "--full", "--batch", str(run["batch"]),
             "--seq", str(run["seq"]), "--steps", str(run["steps"]),
             "--ckpt-every", str(run["ckpt_every"]), "--log-every", "2",
             "--device", "cuda"]
            + ([] if run["layers"] is None else ["--layers", str(run["layers"])]))


def train_launches(cfg, seq: int, patches: int = 0, frames: int = 0) -> dict:
    """{kernel: launches} of one training pass (forward and backward) of
    ``cfg`` at ``seq`` text tokens (after ``patches`` vision patches;
    ``frames`` encoder frames), as each launcher counts them: one flash
    forward an attention and ``kernels_a_call(Sq, Sk, G)`` backward
    kernels (the flash backward's counter counts kernels); a hybrid
    layer's Mamba heads one mLSTM scan and one call of its backward (the
    mLSTM backward's counter counts calls, of ``LAUNCHES`` kernels
    each); an xLSTM pair one mLSTM scan, one sLSTM cell and one call of
    each backward. Under ``cfg.remat`` each layer's forward runs again
    for its backward: every forward kernel twice, the backwards once."""
    from repro_torch.kernels.flash_attention.flash_attention_bwd import (
        kernels_a_call)

    out = dict.fromkeys(TRAIN_LAUNCHES, 0)
    g = cfg.n_heads // cfg.n_kv_heads
    fwd = 2 if cfg.remat else 1
    if cfg.block_type == "xlstm_pair":
        n = cfg.n_layers // 2
        return dict(out, mlstm_scan=fwd * n, mlstm_scan_bwd=n,
                    slstm_cell=fwd * n, slstm_cell_bwd=n)
    if cfg.is_encdec:  # encoder self, decoder self, cross
        attns = ([(frames, frames)] * cfg.n_enc_layers
                 + [(seq, seq), (seq, frames)] * cfg.n_layers)
    else:
        attns = [(patches + seq, patches + seq)] * cfg.n_layers
    out["flash_attention"] = fwd * len(attns)
    out["flash_attention_bwd"] = sum(kernels_a_call(a, b, g) for a, b in attns)
    if cfg.block_type == "hybrid":
        out["mlstm_scan"] = fwd * cfg.n_layers
        out["mlstm_scan_bwd"] = cfg.n_layers
    return out


class _KernelsOf:
    """A launcher's counter scaled to the kernels each of its calls
    launches (``counted_ms`` holds a profile's kernels to it)."""

    def __init__(self, mod, per_call):
        self.mod, self.per_call = mod, per_call

    @property
    def launches(self):
        return self.mod.launches * self.per_call


def mlstm_bwd_flops(b, h, s, dk, dv, normalize, chunk=64):
    """FLOPs the chunkwise backward needs on these shapes (the count of
    ``mlstm_scan_bwd.cu``): per (b, h), with P = dv + 1 (dv without the
    normalizer) and chunks of l steps, the two score matrices l(l+1)(P +
    dk) and the three in-chunk sums l(l+1)(2 dk + dv) a chunk; the three
    scans' carried-state products (2 l P dk twice, 2 l dk dv) in every
    chunk but the first of a sweep and their state updates in every chunk
    but the last; the normalize step's q.n and per-row sums (4 S dk + 4 S
    dv) and dlog_f's two dot products (4 S dk)."""
    p = dv + int(normalize)
    ls = [min(chunk, s - t0) for t0 in range(0, s, chunk)]
    tri = sum(n * (n + 1) for n in ls)
    carried = sum(ls[1:]) + sum(ls[:-1])  # one sweep's inter + update rows
    per = (tri * (p + dk) + tri * (2 * dk + dv)
           + carried * (4 * p * dk + 2 * dk * dv)
           + int(normalize) * 4 * s * (dk + dv) + 4 * s * dk)
    return b * h * per


def mlstm_bwd_inputs(torch, mlaunch, b, h, s, dk, dv, normalize, seed):
    """q, k, v, log_f (the forward tests' distributions), the forward
    kernel's h and a random output gradient, on the card."""
    q, k, v, lf = mlstm_inputs(torch, b, h, s, dk, dv, seed)
    out = mlaunch.mlstm_scan_cuda(q, k, v, lf, normalize=normalize)
    gen = np.random.default_rng(seed + 1)
    dh = torch.from_numpy(gen.standard_normal((b, h, s, dv), np.float32)).cuda()
    return [q, k, v, lf, out, dh]


def check_mlstm_bwd(torch, mbwd, mref, xs, normalize) -> dict:
    """The backward kernel's dq, dk, dv and dlog_f against the plain
    backward's on the same inputs (the forward kernel's h among them),
    each within mlstm_grad_error_bound (dq at its summands' scale);
    returns their max abs errors and shares of the bound."""
    q, k, v, lf, out, dh = xs
    got = mbwd.mlstm_scan_bwd_cuda(q, k, v, lf, out, dh, normalize=normalize)
    want, dq_scale = mref.mlstm_scan_bwd_ref(q, k, v, lf, dh, h=out,
                                             normalize=normalize, dq_scale=True)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv", "dlog_f"), got, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"mlstm backward {name}: shape or non-finite values")
        e = (g - w).abs()
        bound = mref.mlstm_grad_error_bound(w, dq_scale if name == "dq" else None)
        check(bool((e <= bound).all()),
              f"mlstm backward {name} at {tuple(q.shape)} beyond its bound: max "
              f"err {float(e.max())}, {float((e / bound).max()):.3f} of the bound")
        errs[name] = float(e.max())
        errs[name + "_share_of_bound"] = float((e / bound).max())
    return errs


def time_mlstm_bwd(torch, mlaunch, mbwd, mref, case, mem_rate) -> dict:
    """The backward kernels at ``case`` beside the plain backward, a plain
    autograd of the plain scan (``torch.autograd.grad`` on a kept graph
    of ``mlstm_scan_ref``, the ROADMAP's comparison) and the bound:
    operations at the 3xTF32 rate of the tensor cores, the engine the
    kernels run on (the least time; ``bound_ms``), and at f32 on SIMT, the
    SIMT design before it (``bound_ms_simt``); device ms a launch and a call of
    each kernel, and the plan (CTAs, the blocks an SM holds, waves)."""
    b, h, s, dk, dv, normalize = case
    nbytes = 4 * b * h * (s * (2 * dk + dv + 1 + dv + int(normalize) * dv)
                          + s * (2 * dk + dv + 1))
    nxt = rotation(lambda: mlstm_bwd_inputs(torch, mlaunch, b, h, s, dk, dv,
                                            normalize, seed=1), nbytes)

    def kern():
        return mbwd.mlstm_scan_bwd_cuda(*nxt(), normalize=normalize)

    def plain():
        q, k, v, lf, out, dh = nxt()
        return mref.mlstm_scan_bwd_ref(q, k, v, lf, dh, h=out, normalize=normalize)

    q, k, v, lf, _, dh = nxt()
    xs = [x.clone().requires_grad_() for x in (q, k, v, lf)]
    graph = mref.mlstm_scan_ref(*xs, normalize=normalize)

    def autograd():
        return torch.autograd.grad(graph, xs, dh, retain_graph=True)

    flops = mlstm_bwd_flops(b, h, s, dk, dv, normalize)
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = 3 * flops / TF32_OPS_PER_S * 1e3
    simt_ms = flops / FP32_OPS_PER_S * 1e3
    kernels = mbwd.LAUNCHES
    tag = f"{case}"
    t = {"shape": list(case[:5]), "normalize": normalize,
         "kernels_a_call": kernels,
         "ms": cuda_time_ms(kern, iters=20, warmup=3),
         "device_ms": counted_ms(kern, iters=10, label=f"mlstm bwd {tag}",
                                 launcher=_KernelsOf(mbwd, kernels),
                                 symbols=mbwd.KERNELS),
         # one call each: hymba's plain backward takes about 1.5 s a call
         "plain_ms": cuda_time_ms(plain, iters=1, warmup=1),
         "autograd_ms": cuda_time_ms(autograd, iters=1, warmup=1),
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "bound_ms_simt": max(bytes_ms, simt_ms), "gflop": flops / 1e9,
         "mbytes": nbytes / 1e6}
    # each kernel's share of a call: device ms a launch and a call by
    # kernel name (mlstm_bwd_state runs twice a call), over the launches
    # the profile recorded
    calls = 10
    profiled = device_kernels(lambda: [kern() for _ in range(calls)])
    t["device_ms_by_kernel"], t["device_ms_a_call_by_kernel"] = {}, {}
    for sym in mbwd.KERNELS:
        us = sum(u for u, _, name in profiled if sym in name)
        n = sum(c for _, c, name in profiled if sym in name)
        t["device_ms_by_kernel"][sym] = us / n / 1e3 if n else None
        t["device_ms_a_call_by_kernel"][sym] = us / calls / 1e3 if n else None
    got, per_sm, _ = mbwd.kernel_plan(b * h, s, dk, dv, normalize)
    t["plan"] = {sym: {"ctas": got.ctas(sym), "per_sm": per_sm[sym],
                       "waves": got.waves[sym]} for sym in mbwd.KERNELS}
    del graph, xs
    print(f"mlstm_scan_bwd {t['shape']} normalize={normalize}: "
          f"{t['ms']:.5f} ms a call (device {t['device_ms']} ms, {kernels} "
          f"launches a call), plain backward {t['plain_ms']:.3f} ms, autograd "
          f"of the plain scan {t['autograd_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.6f} ms at the 3xTF32 rate ({t['bound_by']}, "
          f"{t['gflop']:.3f} GFLOP, {t['mbytes']:.1f} MB), "
          f"{t['bound_ms_simt']:.6f} ms on SIMT f32; the call at "
          f"{t['bound_ms'] / t['ms']:.3f} / {t['bound_ms_simt'] / t['ms']:.3f} "
          f"of them; device ms a launch by kernel {t['device_ms_by_kernel']}, "
          f"a call {t['device_ms_a_call_by_kernel']}; plan {t['plan']}")
    return t


def mlstm_bwd_phase(torch, mlaunch, mbwd, mref, mem_rate) -> tuple:
    """Phase 26: the backward kernel against the plain backward at
    MLSTM_BWD_CASES and the two timed shapes, then timed at both
    (``time_mlstm_bwd``). Returns (max abs err, errors by shape, timings
    {"xlstm", "hymba"})."""
    worst, errs = 0.0, {}
    for case in MLSTM_BWD_CASES + (MLSTM_BWD_XLSTM, MLSTM_BWD_HYMBA):
        xs = mlstm_bwd_inputs(torch, mlaunch, *case, seed=sum(case[:5]))
        e = check_mlstm_bwd(torch, mbwd, mref, xs, case[5])
        errs[str(case)] = e
        worst = max(worst, *(v for k, v in e.items() if "share" not in k))
        del xs
    print(f"{len(errs)} cases (dq, dk, dv, dlog_f) within mlstm_grad_error_bound "
          f"of the plain backward; max abs err {worst:.3g}; at xlstm-350m's "
          f"training shape {errs[str(MLSTM_BWD_XLSTM)]}")
    torch.cuda.empty_cache()
    times = {"xlstm": time_mlstm_bwd(torch, mlaunch, mbwd, mref, MLSTM_BWD_XLSTM,
                                     mem_rate)}
    torch.cuda.empty_cache()
    times["hymba"] = time_mlstm_bwd(torch, mlaunch, mbwd, mref, MLSTM_BWD_HYMBA,
                                    mem_rate)
    torch.cuda.empty_cache()
    return worst, errs, times


def train_run(workdir: str, arch: str = "xlstm-350m") -> dict:
    """Phases 27 and 30's runs, in this process (a child process of its
    own took about 20 s more a phase: its start and the profiler's):
    ``launch/train.py``'s ``main`` at full width and the depth TRAIN_RUNS
    [ARCH] sets, with its one checkpoint (at ckpt_every, which lies past
    half of steps) in DIR, then resumed from it by a second invocation,
    which writes no checkpoint of its own (the first run's write is the
    one timed and sized); then one more step profiled. Prints the free
    disk before the checkpoint and its size. Peak memory is the run's
    own, above what was allocated before it."""
    import os
    import shutil

    import torch

    from repro_torch import optim
    from repro_torch.common.tree import tree_leaves
    from repro_torch.launch import train
    from repro_torch.models import backbone as bb

    run = TRAIN_RUNS[arch]
    args = train_args(arch)
    ckpt = os.path.join(workdir, "ckpt")
    print(f"disk free under {workdir}: {shutil.disk_usage(workdir).free / 1e9:.1f} GB",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = train.main(args + ["--ckpt-dir", ckpt])
    full_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    last = f"step_{run['ckpt_every']:08d}"
    check(sorted(os.listdir(ckpt)) == [last], f"checkpoints {os.listdir(ckpt)}")
    ckpt_gb = sum(e.stat().st_size for e in os.scandir(os.path.join(ckpt, last))) / 1e9
    print(f"checkpoint: {ckpt_gb:.2f} GB a step; disk free "
          f"{shutil.disk_usage(workdir).free / 1e9:.1f} GB", flush=True)
    cfg, full_hist = full["cfg"], full["history"]
    del full  # its state: the resumed run needs the card's memory
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = train.main(args + ["--ckpt-dir", ckpt, "--ckpt-every",
                                 str(run["steps"] + 1)])
    resumed_s = time.perf_counter() - t0
    shutil.rmtree(ckpt)
    # where a step's time goes: one more step from the run's final state
    params, state = resumed.pop("params"), resumed.pop("opt_state")
    opt = optim.adamw(optim.linear_warmup_cosine(3e-4, warmup=10,
                                                 total_steps=run["steps"]))
    step_fn = bb.make_train_step(cfg, opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in train.build_batch(
        cfg, run["batch"], run["seq"], np.random.default_rng(1)).items()}

    def one():
        step_fn(params, state, batch)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bd = device_breakdown(one, wall, top=8, match=run["match"])
    out = {"n_params": sum(x.numel() for x in tree_leaves(params)),
           "full": full_hist, "resumed": resumed["history"],
           "resumed_start": resumed["start"], "full_s": full_s,
           "resumed_s": resumed_s, "peak_gb": peak / 1e9, "ckpt_gb": ckpt_gb,
           "step_wall_ms": wall * 1e3, "breakdown": bd,
           "launches_a_step": train_launches(cfg, run["seq"])}
    del one, step_fn, params, state, resumed, batch
    torch.cuda.empty_cache()
    return out


def train_on_card(arch: str = "xlstm-350m") -> dict:
    """Phases 27 and 30: ``train_run``, whose history is held here: steps
    1..steps, then ckpt_every + 1 .. steps after the resume, finite
    losses, exactly ``train_launches`` a step in both runs, the resumed
    losses within LOSS_RTOL of the uninterrupted run's (the
    embedding's backward sums its rows with atomics, so the two runs need
    not agree bit for bit on the card)."""
    import tempfile

    run = TRAIN_RUNS[arch]
    steps, every = run["steps"], run["ckpt_every"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        res = train_run(workdir, arch)
    full, resumed = res["full"], res["resumed"]
    want_launches = res["launches_a_step"]
    check([r["step"] for r in full] == list(range(1, steps + 1))
          and [r["step"] for r in resumed] == list(range(every + 1, steps + 1))
          and res["resumed_start"] == every, "training steps")
    check(all(np.isfinite(r["loss"]) for r in full + resumed), "training losses")
    bad = [r for r in full + resumed if r["launches"] != want_launches]
    check(not bad, f"launches a step {bad[:2]}, want {want_launches}")
    want = np.asarray([r["loss"] for r in full[every:]])
    got = np.asarray([r["loss"] for r in resumed])
    gap = float(np.max(np.abs(got - want) / np.abs(want)))
    check(gap <= LOSS_RTOL, f"resumed losses {got} against {want}")
    secs = [r["seconds"] for r in full[1:]]
    tokens = run["batch"] * run["seq"]
    bd = res["breakdown"]
    out = {"params": res["n_params"], "ms_a_step_median": float(np.median(secs)) * 1e3,
           "ms_a_step_mean": float(np.mean(secs)) * 1e3,
           "first_step_ms": full[0]["seconds"] * 1e3,
           "tokens_per_s": tokens / float(np.median(secs)),
           "peak_gb": res["peak_gb"], "ckpt_gb": res["ckpt_gb"],
           "losses": [r["loss"] for r in full],
           "resumed_losses": got.tolist(), "resumed_rel_gap": gap,
           "launches_a_step": want_launches,
           "launches": {k: sum(r["launches"][k] for r in full) for k in want_launches},
           "run_s": res["full_s"], "resumed_run_s": res["resumed_s"],
           "step_wall_ms": res["step_wall_ms"], "breakdown": bd}
    print(f"{arch} training ({res['n_params']} parameters, {run['batch']} x "
          f"{run['seq']} tokens a step): {out['ms_a_step_median']:.2f} ms a step "
          f"(median of steps 2-{steps}; mean {out['ms_a_step_mean']:.2f}, "
          f"step 1 {out['first_step_ms']:.1f}), {out['tokens_per_s']:.0f} tokens/s; "
          f"peak memory {res['peak_gb']:.3f} GB; losses {full[0]['loss']:.4f} -> "
          f"{full[-1]['loss']:.4f}; resumed from step {every}: losses "
          f"within {gap:.3g} (rtol {LOSS_RTOL}); launches a step {want_launches}; "
          f"runs {res['full_s']:.1f} s and {res['resumed_s']:.1f} s with checkpoints "
          f"of {res['ckpt_gb']:.2f} GB")
    print_breakdown(f"a {arch} training step (profiled)", bd)
    for m, v in bd["matched"].items():
        print(f"    {m}: {v['ms']:.3f} ms in {v['calls']} launches")
    return out


# ------------------------------------------------------ LM training (15b) --

# Phase 29: the flash backward against the plain backward at the
# attention families' training shapes, (B, Hq, Hkv, Sq, Sk, d, causal,
# window, softcap): phi4-mini's (8 x 128 tokens), hymba's (2 x 2048, its
# window of 1024), qwen2-vl's (1024 patches + 128 tokens), starcoder2's,
# stablelm's (d = 80: the KD = 128 instance), whisper's cross attention
# (128 decoder queries against 64 frames), and phi4-mini's with a logit
# cap of 50 (no config sets one; the reference takes it).
FLASH_BWD_LM_CASES = (
    ("phi4-mini", (8, 24, 8, 128, 128, 128, True, 0, 0.0)),
    ("hymba", (2, 25, 5, 2048, 2048, 64, True, 1024, 0.0)),
    ("qwen2-vl", (2, 12, 2, 1152, 1152, 128, True, 0, 0.0)),
    ("starcoder2", (2, 36, 4, 128, 128, 128, True, 0, 0.0)),
    ("stablelm", (2, 32, 32, 128, 128, 80, True, 0, 0.0)),
    ("whisper cross", (2, 16, 16, 128, 64, 64, False, 0, 0.0)),
    ("phi4-mini softcap 50", (8, 24, 8, 128, 128, 128, True, 0, 50.0)),
)


def flash_bwd_lm_bound_ms(case, mem_rate) -> dict:
    """The backward's bound at ``case``: q, out, dout and the lse read
    once, k and v read once at K/V-head width, dq, dk and dv written once,
    over the memory rate; and the five products' 2 d operations for each
    visible (query, key) pair of each query head (the masks decide how
    many: this run's work, not the full S^2), at the 3xTF32 rate (495 / 3
    TFLOP/s, the least for f32 data) and at SIMT f32 (67), the engine the
    two kernels run them on."""
    b, hq, hkv, sq, sk, d, causal, window, _ = case
    nbytes = 4 * (b * hq * sq * (4 * d + 1) + b * hkv * sk * 4 * d)
    ops = 10 * d * visible_pairs(sq, sk, causal, window) * b * hq
    bytes_ms = nbytes / mem_rate * 1e3
    tc_ms, simt_ms = ops / (TF32_OPS_PER_S / 3) * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, tc_ms),
            "bound_by": "bytes" if bytes_ms >= tc_ms else "operations",
            "bound_ms_simt": max(bytes_ms, simt_ms), "gflop": ops / 1e9,
            "mbytes": nbytes / 1e6}


def flash_bwd_phase(torch, flaunch, fbwd, fref, mem_rate) -> dict:
    """Phase 29: at each FLASH_BWD_LM_CASES shape, the forward with its
    lse against the plain forward, then the backward kernels against the
    plain backward on the same inputs within ``flash_grad_error_bound``
    and two calls equal bit for bit; timed (CUDA events and device time,
    inputs rotated over ROTATE_BYTES) beside the plain backward, the
    bound and SDPA's memory-efficient backward (K/V repeated to the query
    heads in its graph, as that kernel takes no grouped heads, and the
    repeat's backward summing dk and dv; a window as a boolean mask; no
    logit cap, so none at the capped case): a yardstick, timed here and
    never on the path. Returns {label: record}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    out = {}
    for label, case in FLASH_BWD_LM_CASES:
        b, hq, hkv, sq, sk, d, causal, window, softcap = case
        form = dict(causal=causal, window=window, softcap=softcap)
        group = hq // hkv

        def make(seed=sq + d + hq):
            q, k, v = flash_inputs(torch, b, hq, hkv, sq, sk, d, seed=seed)
            o, lse = flaunch.flash_attention_cuda(q, k, v, return_lse=True, **form)
            dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
                (b, hq, sq, d), np.float32)).cuda()
            return [q, k, v, o, dout, lse]

        xs = make()
        q, k, v, o, dout, lse = xs
        want_o, want_lse = fref.flash_attention_ref(q, k, v, return_lse=True, **form)
        tol = fref.TOL[torch.float32]
        fin = torch.isfinite(want_lse)
        check(torch.equal(fin, torch.isfinite(lse))
              and bool(((o - want_o).abs() <= tol + tol * want_o.abs()).all())
              and bool(((lse - want_lse)[fin].abs()
                        <= tol + tol * want_lse[fin].abs()).all()),
              f"flash forward with lse at {label} {case}: beyond {tol}")
        del want_o, want_lse
        before = fbwd.launches
        got = fbwd.flash_attention_bwd_cuda(*xs, **form)
        again = fbwd.flash_attention_bwd_cuda(*xs, **form)
        torch.cuda.synchronize()
        n = fbwd.kernels_a_call(sq, sk, group)
        check(fbwd.launches - before == 2 * n,
              f"flash backward at {label}: {fbwd.launches - before} launches, "
              f"want {2 * n}")
        want = fref.flash_attention_bwd_ref(*xs, **form)
        errs, shares = {}, {}
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            err = (g - w).abs()
            bound = fref.flash_grad_error_bound(w)
            check(g.shape == w.shape and bool(torch.isfinite(g).all())
                  and bool((err <= bound).all()),
                  f"flash backward {name} at {label} {case} beyond its bound: max "
                  f"err {float(err.max())}")
            check(torch.equal(g, a), f"flash backward {name} at {label}: two calls "
                                     "differ")
            errs[name] = float(err.max())
            shares[name] = float((err / bound).max())
        del got, again, want
        torch.cuda.empty_cache()
        per_set = sum(x.numel() for x in xs) * 4
        nxt = rotation(make, per_set)

        def kern():
            return fbwd.flash_attention_bwd_cuda(*nxt(), **form)

        def plain():
            return fref.flash_attention_bwd_ref(*nxt(), **form)

        t = {"shape": list(case[:6]), "causal": causal, "window": window,
             "softcap": softcap, "kernels_a_call": n, "max_abs_err": errs,
             "share_of_bound": shares, "deterministic": True,
             "ms": cuda_time_ms(kern, iters=10, warmup=2),
             "device_ms": counted_ms(kern, iters=5, label=f"flash bwd {label}",
                                     launcher=fbwd, symbols=FLASH_BWD_SYMBOLS),
             "plain_ms": cuda_time_ms(plain, iters=3, warmup=1)}
        t.update(flash_bwd_lm_bound_ms(case, mem_rate))
        t["library_ms"] = t["library_device_ms"] = t["library_max_abs_err"] = None
        if not softcap:  # SDPA takes no logit cap
            mask = (torch.from_numpy(visible_mask(sq, sk, causal, window)).cuda()
                    if window > 0 or (causal and sq != sk) else None)
            qg, kg, vg = (x.detach().requires_grad_() for x in xs[:3])
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                # the memory-efficient kernel takes one K/V head a query
                # head: K/V repeated in the graph, whose backward sums dk
                # and dv over each group (timed with SDPA's)
                lo = F.scaled_dot_product_attention(
                    qg, kg.repeat_interleave(group, 1), vg.repeat_interleave(group, 1),
                    attn_mask=mask, is_causal=causal and mask is None)
            check("EfficientAttention" in lo.grad_fn.name(),
                  f"SDPA took {lo.grad_fn.name()}, not the memory-efficient kernel")

            def library():
                return torch.autograd.grad(lo, (qg, kg, vg), dout, retain_graph=True)

            lib = library()
            w_plain = fref.flash_attention_bwd_ref(*xs, **form)
            t["library_max_abs_err"] = max(float((g - w).abs().max())
                                           for g, w in zip(lib, w_plain))
            del lib, w_plain
            t["library_ms"] = cuda_time_ms(library, iters=10, warmup=2)
            t["library_device_ms"] = counted_ms(library, iters=5,
                                                label=f"SDPA backward {label}")
            del lo, qg, kg, vg
        print(f"flash backward, {label} {case}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']} ms, {n} kernels a call), plain {t['plain_ms']:.3f} "
              f"ms, SDPA efficient backward "
              f"{None if t['library_ms'] is None else round(t['library_ms'], 4)} ms "
              f"(device {t['library_device_ms']}, max abs diff to plain "
              f"{t['library_max_abs_err']}); bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['gflop']:.2f} GFLOP, {t['mbytes']:.1f} MB; "
              f"{t['bound_ms_simt']:.4f} ms on SIMT f32); kernel at "
              f"{t['bound_ms'] / t['ms']:.3f} / {t['bound_ms_simt'] / t['ms']:.3f} "
              f"of them; max abs err {errs}, share of the bound {shares}; two "
              f"calls bit for bit")
        out[label] = t
        del xs, nxt
        torch.cuda.empty_cache()
    return out


# Phase 31: the other attention families at full width, 3 AdamW steps
# each (the CLI's optimizer and batches), at the depth the training state
# (16 B a parameter: parameters, gradients, two moments) leaves room for
# on an 80 GB card with about 10 GB for activations and AdamW's
# out-of-place copies: (config, layers (None: all), batch, text tokens).
# qwen2-vl's batches carry its 1024 patches, whisper's its 64 frames.
# nemotron-4-15b (one full-width layer and its 256k vocabulary already
# about 56 GB before AdamW's copies) and dbrx-132b (72 GB) train only in
# phase 32.
FAMILY_TRAIN_RUNS = (
    ("qwen2_vl_2b", None, 2, 128),
    ("whisper_medium", None, 2, 128),
    ("stablelm_3b", 4, 2, 128),
    ("phi4_mini_3p8b", 8, 8, 128),
    ("starcoder2_7b", 2, 2, 128),
    ("deepseek_moe_16b", 2, 2, 128),
)
FAMILY_TRAIN_STEPS = 3


def family_training(torch, counted) -> dict:
    """Phase 31: each FAMILY_TRAIN_RUNS model from random weights (seed
    0, drawn on the card), FAMILY_TRAIN_STEPS steps of ``make_train_step``
    with the CLI's AdamW on ``launch/train.py``'s batches: finite losses,
    ``train_launches`` a step, ms a step (the last steps), tokens/s, peak
    memory."""
    from repro_torch import optim
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_batch
    from repro_torch.models import backbone as bb

    runs = {}
    for name, layers, batch, seq in FAMILY_TRAIN_RUNS:
        t0 = time.perf_counter()
        cfg = cut_cfg(get_config(name), layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = bb.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                device="cuda")
        n_params = sum(x.numel() for x in tree_leaves(params))
        opt = optim.adamw(optim.linear_warmup_cosine(3e-4, warmup=10,
                                                     total_steps=FAMILY_TRAIN_STEPS))
        step_fn = bb.make_train_step(cfg, opt)
        state = opt.init(params)
        rng = np.random.default_rng(0)
        patches = cfg.vision_tokens if cfg.frontend == "vision_stub" else 0
        want = train_launches(cfg, seq, patches=patches, frames=64)
        losses, secs = [], []
        for _ in range(FAMILY_TRAIN_STEPS):
            b = {k: torch.from_numpy(v).cuda()
                 for k, v in build_batch(cfg, batch, seq, rng).items()}
            for m in counted.values():
                m.launches = 0
            torch.cuda.synchronize()
            ts = time.perf_counter()
            params, state, metrics = step_fn(params, state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
            losses.append(float(metrics["loss"]))
            got = {k: m.launches for k, m in counted.items()}
            check(got == dict.fromkeys(counted, 0) | want,
                  f"{cfg.name} training launches {got}, want {want}")
        check(all(np.isfinite(x) for x in losses), f"{cfg.name} losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        tokens = batch * (seq + patches)
        ms = float(np.median(secs[1:])) * 1e3
        runs[cfg.name] = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
                          "params": n_params, "batch": batch, "seq": seq,
                          "patches": patches, "ms_a_step": ms,
                          "first_step_ms": secs[0] * 1e3,
                          "tokens_per_s": tokens / ms * 1e3,
                          "peak_gb": peak / 1e9, "losses": losses,
                          "launches_a_step": want,
                          "phase_s": time.perf_counter() - t0}
        print(f"{cfg.name} training at {cfg.n_layers} layers"
              f"{f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''} "
              f"({n_params} parameters), {batch} x {seq + patches} tokens: "
              f"{ms:.1f} ms a step (median of steps 2-{FAMILY_TRAIN_STEPS}; step 1 "
              f"{secs[0] * 1e3:.1f}), {tokens / ms * 1e3:.0f} tokens/s; peak memory "
              f"{peak / 1e9:.2f} GB; losses {[round(x, 4) for x in losses]}; "
              f"launches a step {want}; {runs[cfg.name]['phase_s']:.1f} s")
        del params, state, step_fn, b, metrics
    torch.cuda.empty_cache()
    return runs


# Phase 32: every attention family, card against CPU, at narrow widths
# that keep its group G = Hq / Hkv (d_model 256, head dim 32; stablelm's
# 80) and, for hymba, a window of 64 that binds at 2 x 128 tokens; 2
# layers (whisper 2 + 2; qwen2-vl 64 patches), ``reduced()``'s vocabulary
# and experts; the loss and every gradient of one batch, then 3 steps of
# the CLI's AdamW, held to phase 28's tolerances.
CARD_CPU_TRAIN = {
    "phi4_mini_3p8b": dict(n_heads=6, n_kv_heads=2),
    "hymba_1p5b": dict(n_heads=5, n_kv_heads=1, window=64),
    "qwen2_vl_2b": dict(n_heads=6, n_kv_heads=1, mrope_sections=(4, 6, 6),
                        vision_tokens=64),
    "starcoder2_7b": dict(n_heads=9, n_kv_heads=1),
    "nemotron_4_15b": dict(n_heads=6, n_kv_heads=1),
    "dbrx_132b": dict(n_heads=6, n_kv_heads=1),
    "stablelm_3b": dict(n_heads=4, n_kv_heads=4, head_dim=80),
    "deepseek_moe_16b": dict(n_heads=4, n_kv_heads=4),
    "whisper_medium": dict(n_heads=4, n_kv_heads=4),
}
CARD_CPU_BATCH, CARD_CPU_SEQ = 2, 128


def card_cpu_train_cfg(name):
    """Phase 32's config of ``name``: ``reduced()`` at d_model 256, head
    dim 32, with CARD_CPU_TRAIN's heads."""
    from repro_torch.configs import get_config

    return get_config(name).reduced().replace(
        **dict(dict(d_model=256, head_dim=32), **CARD_CPU_TRAIN[name]))


def lm_train_card_vs_cpu(torch, counted, cfg) -> dict:
    """Phases 28 and 32: ``cfg`` from the same weights (seed 0, drawn on
    the CPU) on the card and on the CPU; the loss and every gradient of
    one batch of CARD_CPU_BATCH x CARD_CPU_SEQ tokens, then 3 steps of
    the CLI's AdamW (``make_train_step``): losses within LOSS_RTOL,
    gradients and moments within TRAIN_GRAD_REL of each leaf's largest,
    parameters within ADAM_STEP_BOUND times the summed learning rates;
    on the card ``train_launches`` a pass. With MoE layers every router
    call's choices equal on both, the batches' seed the first of
    MOE_SEEDS whose CPU run keeps each token's top-k / (k+1) gap at least
    MOE_GAP."""
    from repro_torch import optim
    from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.launch.train import build_batch
    from repro_torch.models import backbone as bb

    moe = cfg.n_experts > 0
    cpu_params = bb.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = {"cpu": cpu_params, "cuda": tree_map(lambda x: x.cuda(), cpu_params)}
    lr = optim.linear_warmup_cosine(3e-4, warmup=10, total_steps=TRAIN_STEPS)

    def run(dev, batches):
        for m in counted.values():
            m.launches = 0
        with moe_recording("_route", moe) as routes:
            b0 = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
            leaves = [x.detach().requires_grad_() for x in tree_leaves(params[dev])]
            total, _ = bb.loss_fn(tree_unflatten(params[dev], leaves), cfg, b0)
            grads = [g.cpu() for g in torch.autograd.grad(total, leaves)]
            opt = optim.adamw(lr)
            step_fn = bb.make_train_step(cfg, opt)
            # a clone: the step steps what it is given in place
            p = tree_map(torch.clone, params[dev])
            s, losses = opt.init(p), []
            for batch in batches:
                p, s, metrics = step_fn(p, s, {k: torch.from_numpy(v).to(dev)
                                               for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
        return {"loss0": float(total.detach()), "grads": grads, "losses": losses,
                "params": [x.cpu() for x in tree_leaves(p)],
                "moments": [x.cpu() for x in tree_leaves(s["mu"]) + tree_leaves(s["nu"])],
                "launches": {k: m.launches for k, m in counted.items()},
                "routes": [idx.cpu() for _, idx, _ in routes],
                "gap": min((float((torch.topk(pr.detach(), cfg.top_k + 1, dim=-1).values[:, -2]
                                   - torch.topk(pr.detach(), cfg.top_k + 1, dim=-1).values[:, -1]
                                   ).min()) for _, _, pr in routes), default=None)}

    for seed in range(MOE_SEEDS if moe else 1):
        batches = [build_batch(cfg, CARD_CPU_BATCH, CARD_CPU_SEQ,
                               np.random.default_rng(seed)) for _ in range(3)]
        cpu = run("cpu", batches)
        if not moe or cpu["gap"] >= MOE_GAP:
            break
    check(not moe or cpu["gap"] >= MOE_GAP,
          f"{cfg.name}: no batch seed of {MOE_SEEDS} keeps the top-k gap {MOE_GAP}: "
          f"{cpu['gap']}")
    card = run("cuda", batches)
    if moe:
        check(len(card["routes"]) == len(cpu["routes"]) and all(
            torch.equal(torch.sort(a, -1).values, torch.sort(b, -1).values)
            for a, b in zip(card["routes"], cpu["routes"])),
            f"{cfg.name} card vs CPU: the routers chose other experts")
    patches = cfg.vision_tokens if cfg.frontend == "vision_stub" else 0
    per = train_launches(cfg, CARD_CPU_SEQ, patches=patches, frames=64)
    want = dict.fromkeys(counted, 0) | {k: v * (1 + len(batches)) for k, v in per.items()}
    check(card["launches"] == want, f"{cfg.name} card launches {card['launches']}, "
          f"want {want}")

    def rel_gap(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(a, b))

    lr_sum = sum(float(lr(torch.tensor(t, dtype=torch.int32))) for t in (1, 2, 3))
    g_gap = rel_gap(card["grads"], cpu["grads"])
    m_gap = rel_gap(card["moments"], cpu["moments"])
    l_gap = max(abs(a - b) / abs(b) for a, b in zip([card["loss0"]] + card["losses"],
                                                    [cpu["loss0"]] + cpu["losses"]))
    p_err = max(float((x - y).abs().max()) for x, y in zip(card["params"], cpu["params"]))
    far = sum(int(((x - y).abs() > 1e-6).sum()) for x, y in zip(card["params"],
                                                                cpu["params"]))
    rec = {"loss_rel_gap": l_gap, "grad_rel_gap": g_gap, "moment_rel_gap": m_gap,
           "param_max_abs": p_err, "param_bound": ADAM_STEP_BOUND * lr_sum,
           "params_beyond_1e-6": far,
           "n_params": sum(x.numel() for x in cpu["params"]),
           "group": cfg.n_heads // cfg.n_kv_heads, "launches": card["launches"],
           "moe_smallest_gap": cpu["gap"], "moe_seed": seed if moe else None}
    print(f"{cfg.name} training card vs CPU (G {rec['group']}, {cfg.n_layers} "
          f"layers, d {cfg.d_model}, {CARD_CPU_BATCH} x {CARD_CPU_SEQ + patches} "
          f"tokens): losses within {l_gap:.3g} (rtol {LOSS_RTOL}); gradients "
          f"{g_gap:.3g} of each leaf's largest, moments {m_gap:.3g} (tol "
          f"{TRAIN_GRAD_REL}); parameters max abs {p_err:.3g} (bound "
          f"{ADAM_STEP_BOUND * lr_sum:.3g}), {far} of {rec['n_params']} more than "
          f"1e-6 apart; card launches {card['launches']}"
          + (f"; routers equal, smallest top-k gap {cpu['gap']:.3g} (seed {seed})"
             if moe else ""))
    check(l_gap <= LOSS_RTOL, f"{cfg.name} losses card {card['losses']} cpu "
          f"{cpu['losses']}")
    check(g_gap <= TRAIN_GRAD_REL and m_gap <= TRAIN_GRAD_REL,
          f"{cfg.name} gradients {g_gap} or moments {m_gap} beyond {TRAIN_GRAD_REL}")
    check(p_err <= ADAM_STEP_BOUND * lr_sum + 1e-6, f"{cfg.name} parameters {p_err}")
    return rec


def baseline_variants(torch, spec, data, counted) -> dict:
    """Phase 21's second part: the seven baselines that train the
    recurrent and transformer encoders (all but FedMA, which refuses
    them, as the reference asserts) once each at full width (d_hidden
    1024, 4 heads of 256; the first BASELINE_VARIANT_CLIENTS of phase 7's
    clients, 1 round of 1 local epoch):
    wall, blend launches against ``baseline_blends`` (counts set to 0
    just before a run, read just after), forward and backward launches of
    the encoder's kernels (both > 0, no other kernel but the blend), the
    six metrics each NaN or in [0, 1]."""
    import repro_torch.core.baselines as bl
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.encoders import EncoderConfig, init_client_models
    from repro_torch.core.federation import FedConfig

    clients, va, te = data
    # 4 of phase 7's 16 clients: the fourteen runs take about 90 s with 16
    clients = clients[:BASELINE_VARIANT_CLIENTS]
    cfg = FedConfig(n_clients=len(clients), rounds=1, local_epochs=1, lr=1e-2,
                    batch_size=64)
    blaunch = counted["blend_params"]
    runs = {}
    for enc_type, (fwd, bwd, _) in VARIANT_KERNELS.items():
        ecfg = EncoderConfig(d_hidden=1024, n_layers=4, enc_type=enc_type,
                             n_heads=4)
        key_leaves = {k: len(tree_leaves(v)) for k, v in init_client_models(
            torch.Generator().manual_seed(0), spec, ecfg, device="cpu").items()}
        try:
            bl.BASELINES["fedma"](torch.Generator(), spec, ecfg, clients, va, te,
                                  cfg, device="cuda")
            check(False, f"FedMA trained the {enc_type} encoders")
        except NotImplementedError as e:
            check("baselines.py:289" in str(e), f"FedMA's refusal: {e}")
        for name in BASELINE_ORDER:
            if name == "fedma":
                continue
            torch.cuda.synchronize()
            for m in counted.values():
                m.launches = 0
            t0 = time.perf_counter()
            res, _ = bl.BASELINES[name](torch.Generator().manual_seed(0), spec,
                                        ecfg, clients, va, te, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: m.launches for k, m in counted.items()}
            blends = baseline_blends(name, clients, key_leaves, cfg.rounds)
            runs[f"{name}/{enc_type}"] = {"wall_s": wall, "launches": got,
                                          "metrics": res}
            print(f"{name} ({enc_type}): {wall:.3f} s wall; launches {got} "
                  f"(blends want {blends}); "
                  f"{ {k: round(v, 4) for k, v in res.items()} }")
            check(got["blend_params"] == blends,
                  f"{name} ({enc_type}): {got['blend_params']} blends, want {blends}")
            check(got[fwd] > 0 and got[bwd] > 0
                  and all(v == 0 for k, v in got.items()
                          if k not in (fwd, bwd, "blend_params")),
                  f"{name} ({enc_type}): launches {got}")
            check(sorted(res) == sorted(BASELINE_KEYS)
                  and all(np.isnan(v) or 0.0 <= v <= 1.0 for v in res.values()),
                  f"{name} ({enc_type}): metrics {res}")
    torch.cuda.empty_cache()
    return runs


def cpu_model(torch) -> str:
    """The host CPU: its model name where /proc/cpuinfo gives one, its
    architecture, the vector instructions PyTorch's CPU kernels use, and
    its core count."""
    import os
    import platform

    name = "model name not in /proc/cpuinfo"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return (f"{name}; {platform.machine()}, "
            f"{torch.backends.cpu.get_cpu_capability()}, {os.cpu_count()} cores")


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--cli-child":
        return cli_child(sys.argv[2])
    # --phase4-repeats N: phase 4 served and checked N times (1 as run
    # with no arguments)
    repeats = 1
    if len(sys.argv) == 3 and sys.argv[1] == "--phase4-repeats":
        repeats = int(sys.argv[2])
    elif len(sys.argv) != 1:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    # the CPU references' sums depend on the thread count (ROADMAP fault
    # (n)): fixed before the first CPU product
    torch.set_num_threads(CPU_THREADS)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # the build (phase 2) runs while the modules import and phase 1 runs
    build = {"t0": time.perf_counter()}

    def run_build():
        try:
            build["libs"] = _build.build_all()
        except BaseException as e:  # re-raised in phase 2
            build["error"] = e
        build["s"] = time.perf_counter() - build["t0"]

    build_thread = threading.Thread(target=run_build, name="build")
    build_thread.start()

    from repro_torch.configs import get_config
    from repro_torch.core import encoders as enc
    from repro_torch.data.synthetic import TaskSpec
    from repro_torch.kernels.blendavg import blendavg as blaunch
    from repro_torch.kernels.blendavg import ref as bref
    from repro_torch.kernels.flash_attention import flash_attention as flaunch
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fbwd
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mlaunch
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as mbwd
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.kernels.slstm_cell import ref as sref
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch
    from repro_torch.kernels.slstm_cell import slstm_cell_bwd as sbwd
    from repro_torch.kernels.wire_codec import ops, ref
    from repro_torch.kernels.wire_codec import wire_codec as launcher
    from repro_torch.launch import serve_federated as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    print(smi)
    mem_rate = hbm_bytes_per_s(kind)

    phase("2 build")
    build_thread.join()
    if "error" in build:
        raise build["error"]
    print(f"built {[p.name for p in build['libs']]} in {build['s']:.2f} s, "
          "from before the imports")
    for src in _build.sources():  # registers, stack and spills of each kernel
        for name, info in ptxas_summary(_build.report(src)):
            print(f"{src.name}: {name}: {info}")

    counted = {"wire_codec": launcher, "blend_params": blaunch,
               "slstm_cell": slaunch, "flash_attention": flaunch,
               "mlstm_scan": mlaunch, "slstm_cell_bwd": sbwd,
               "flash_attention_bwd": fbwd, "mlstm_scan_bwd": mbwd}
    spec = TaskSpec("blendfl-1024", "multilabel", 25, 64, 128, 64, 128)
    ecfg = enc.EncoderConfig(d_hidden=1024, n_layers=4, enc_type="mlp")
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = enc.init_client_models(gen, spec, ecfg, device="cuda")
    gmv = enc.fusion_init(gen, ecfg.d_hidden, spec.out_dim, device="cuda")

    phase("3 wire codec against plain")
    xg = np.random.default_rng(1)
    with torch.no_grad():
        feats = [enc.encoder_apply(models[f], torch.from_numpy(
            xg.standard_normal((64, 64, 128)).astype(np.float32)).cuda(), ecfg)
            for f in ("f_A", "f_B")]
    max_err, train_errs = 0.0, {}
    cases = kernel_cases(torch, feats)
    for label, x, k, quantize in cases:
        err = check_kernel(torch, ops, launcher, ref, x, k, quantize)
        max_err = max(max_err, err)
        if label.startswith("train_"):  # per message shape and dtype
            shape = label.split("/")[0]
            train_errs[shape] = max(train_errs.get(shape, 0.0), err)
    print(f"{len(cases)} cases match the plain version; max abs err {max_err:.3g}")
    print(f"training message shapes, max abs err over the codecs: {train_errs}")
    del cases, x  # the training-shape messages: free before phase 7
    timings = [time_codec(torch, ops, launcher, ref, x, k, mem_rate)
               for x, k in ((feats[0][:2].contiguous(), 256),
                            (feats[0][:16].contiguous(), 256),
                            (feats[0], 256),
                            (torch.rand(64, 25, device="cuda"), 7))]
    # the launch floor: the kernel at its least work, one row of 32
    floor = time_codec(torch, ops, launcher, ref,
                       torch.rand(1, 32, device="cuda"), 8, mem_rate)
    for t in timings + [floor]:
        print_codec_time(t)
    print(f"wire_codec launch floor: {floor['ms']:.5f} ms a call, device "
          f"{floor['device_ms']} ms at (1, 32); (64, 1024): {timings[2]['ms']:.5f} "
          f"ms, device {timings[2]['device_ms']} ms")

    phase("4 full-width serving")
    print(f"CPU: {cpu_model(torch)}; {torch.get_num_threads()} threads (pinned to "
          f"{CPU_THREADS}), MKL {torch.backends.mkl.is_available()}")
    serve4 = full_width_serving(torch, spec, ecfg, models, gmv, counted)
    cpu_local = [serve4["tolerance"]["engine vs cpu (local routes)"]["max_err"]]
    for _ in range(repeats - 1):  # fault (n): does the CPU's reading move?
        again = full_width_serving(torch, spec, ecfg, models, gmv, counted)
        cpu_local.append(again["tolerance"]["engine vs cpu (local routes)"]["max_err"])
        del again
    print(f"phase 4 engine vs cpu (local routes) max abs err over {repeats} "
          f"run(s): {cpu_local}")
    launches = serve4["launches"]["wire_codec"]
    vfl_batches = serve4["batches"]["vfl_fallback"]
    print(f"wire_codec launches {launches} over {vfl_batches} VFL micro-batches")
    check(vfl_batches > 0 and launches == 3 * vfl_batches,
          f"wire_codec launches {launches} != 3 x {vfl_batches} VFL batches")
    check(all(n == 0 for name, n in serve4["launches"].items()
              if name != "wire_codec"),
          f"mlp serving launched another kernel: {serve4['launches']}")
    engine = serve4.pop("engine")
    for mix in MIXES:  # where the time goes: each mix again under the profiler
        print_breakdown(mix, device_breakdown(
            lambda: sf.serve_mix(engine, spec, mix, 64, rows=64, seed=0,
                                 salt=MIX_SALT[mix]),
            serve4["rows_by_mix"][mix]["wall_s"]))

    phase("5 CLI selftest")
    launcher.launches = blaunch.launches = 0
    sf.main(["--selftest", "--codec", "int8_topk", "--device", "cuda",
             "--train-rounds", "2", "--clients", "3"])
    check(blaunch.launches > 0, "CLI selftest trained without the blend kernel")
    check(launcher.launches > 0, "CLI selftest launched no wire_codec kernel")
    print(f"CLI selftest: trained inline with {blaunch.launches} blend launches; "
          f"served with {launcher.launches} wire_codec launches")

    phase("6 blend kernel against plain")
    blend_err, n_cases = 0.0, 0
    for l, n in BLEND_TEST_SHAPES + BLEND_MAIN_SHAPES + BLEND_SAMPLED_SHAPES:
        for dtype in (None, torch.bfloat16):
            x, omega = blend_inputs(torch, l, n, seed=7 * l + n, dtype=dtype)
            blend_err = max(blend_err, check_blend(torch, blaunch, bref, x, omega))
            n_cases += 1
    x, _ = blend_inputs(torch, 16, 131072, seed=3)
    zero = blaunch.blend_params_cuda(x, torch.zeros(16, device="cuda"))
    check(bool((zero == 0).all()), "an all-zero omega does not give zeros")
    del x, zero
    print(f"{n_cases + 1} cases match the plain version within the bound; "
          f"max abs err {blend_err:.3g}")
    blend_times = [time_blend(torch, blaunch, bref, l, n, mem_rate)
                   for l, n in BLEND_MAIN_SHAPES + BLEND_SAMPLED_SHAPES[:2]]
    for t in blend_times:
        print(f"blend {t['shape']}: kernel {t['ms']:.5f} ms (device "
              f"{t['device_ms']} ms), plain {t['plain_ms']:.5f} ms (device "
              f"{t['plain_device_ms']} ms), omega @ stacked {t['library_ms']:.5f} "
              f"ms (device {t['library_device_ms']} ms); bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")

    round_blends = round_blend(torch, blaunch, bref, spec, ecfg, mem_rate)

    phase("7 full-width training")
    del engine, models, gmv, feats, serve4
    torch.cuda.empty_cache()
    train = full_width_training(torch, spec, ecfg, blaunch, bref, launcher,
                                ops, ref, mem_rate)

    phase("8 card against CPU")
    card_vs_cpu(torch)
    card_vs_cpu(torch, rounds=1, codec="int8_topk")
    # a telemetry policy that reads no float omega: both sample alike;
    # data seed 5 keeps every BlendAvg delta of the CPU run 1.5e-3 from 0
    card_vs_cpu(torch, rounds=3, data_seed=5, n_sampled=2, async_mode=True,
                policy="staleness")
    card_vs_cpu(torch, strategy="scaffold", server_opt="adam")
    card_vs_cpu(torch, n_clients=4, strategy="median")

    phase("9 sLSTM cell against plain")
    slstm_err, slstm_times = slstm_phase(torch, slaunch, sref, mem_rate)

    phase("10 flash attention against plain")
    flash_err, flash_times = flash_phase(torch, flaunch, fref, mem_rate)

    phase("11 full-width serving, recurrent and transformer encoders")
    variants = variant_serving(torch, spec, enc, sf, counted)

    phase("12 CLI selftest, recurrent and transformer encoders")
    variant_cli(sf, slaunch, flaunch, sbwd, fbwd)

    phase("13 mLSTM scan against plain")
    mlstm_err, mlstm_main_errs, mlstm_time = mlstm_phase(
        torch, mlaunch, mref, mem_rate, ptxas_summary(_build.report(mlaunch.SOURCE)))

    phase("14 sLSTM cell with a state against plain")
    slstm_state_err, slstm_state_times = slstm_state_phase(torch, slaunch, sref,
                                                           mem_rate)

    phase("15 full-width xlstm-350m serving")
    lm, lm_params, lm_cfg = lm_family(
        torch, counted, "xlstm_350m", batch=LM_BATCH, prompt=LM_PROMPT,
        gen=LM_GEN, profile=True)

    phase("16 xlstm-350m card against CPU")
    lm["card_vs_cpu"] = lm_family_card_vs_cpu(torch, lm_params, lm_cfg,
                                              layers=None, batch=2, prompt=128,
                                              gen=4)
    del lm_params
    torch.cuda.empty_cache()

    phase("17 full-width sampled and strategy rounds")
    data = train.pop("data")
    sampled = sampled_training(torch, spec, ecfg, data, counted,
                               train["round_wall_s"])

    phase("18 full-width sharded rounds through the batcher")
    sharded = sharded_training(torch, spec, counted)

    phase("19 the training CLI on the card")
    cli_on_card()

    phase("20 sharded rounds, card against CPU")
    sharded_card_vs_cpu(torch)

    phase("21 full-width baselines")
    test = train.pop("test")
    baselines = baselines_phase(torch, spec, ecfg, data + (test,), blaunch, bref)
    torch.cuda.empty_cache()
    baselines["variants"] = baseline_variants(torch, spec, data + (test,), counted)

    phase("22 training the recurrent and transformer encoders")
    bwd_times = backward_kernels(torch, mem_rate)
    trained = variant_training(torch, spec, data + (test,), counted)
    del data, test
    torch.cuda.empty_cache()
    for enc_type in VARIANT_KERNELS:
        # data seeds 0 and 2; card_vs_cpu prints the validation AUROC pairs
        # the card and the CPU order differently, the one way their omegas
        # can part (each pair moves them 1e-4 to 6e-4 here: PERF.md section 7)
        for data_seed in (0, 2):
            worst = card_vs_cpu(torch, data_seed=data_seed, enc_type=enc_type)
            check(worst["smallest_delta"] >= 1e-3,
                  f"{enc_type} card vs CPU: a BlendAvg delta "
                  f"{worst['smallest_delta']} within 1e-3 of a tie")
            trained[enc_type][f"card_vs_cpu_seed{data_seed}"] = worst
    lm_runs = lm_phases(torch, counted)
    torch.cuda.empty_cache()

    phase("26 mLSTM backward against plain")
    mbwd_err, mbwd_errs, mbwd_times = mlstm_bwd_phase(torch, mlaunch, mbwd, mref,
                                                      mem_rate)

    phase("27 full-width xlstm-350m training through launch/train.py, 8 of 24 layers")
    lm_train = train_on_card()

    phase("28 xlstm-350m training, card against CPU")
    lm_train["card_vs_cpu"] = lm_train_card_vs_cpu(
        torch, counted, get_config("xlstm_350m").replace(n_layers=TRAIN_CPU_LAYERS))
    torch.cuda.empty_cache()

    phase("29 flash backward against plain at the training shapes")
    fbwd_lm = flash_bwd_phase(torch, flaunch, fbwd, fref, mem_rate)

    phase("30 full-width hymba-1.5b training through launch/train.py, 4 of 32 layers")
    hymba_train = train_on_card("hymba-1.5b")

    phase("31 the other attention families' training at full width")
    family_train = family_training(torch, counted)

    phase("32 every attention family's training, card against CPU")
    family_card_cpu = {name: lm_train_card_vs_cpu(torch, counted,
                                                  card_cpu_train_cfg(name))
                       for name in CARD_CPU_TRAIN}

    phase("33 production variants: bf16 serving at prefill_32k, decode_32k and "
          "long_500k")
    production = production_phase(torch, counted,
                                  (flaunch, fref, mlaunch, mref, slaunch, sref),
                                  mem_rate)

    phase("34 production variants: bf16 training at train_4k")
    train_4k = production_training(torch, counted, (flaunch, fbwd, fref, mlaunch,
                                                    mbwd), mem_rate)
    phase(None)
    print("xlstm-350m serving: " + json.dumps(
        {k: v for k, v in lm.items() if k != "breakdown"}))

    main_t = timings[2]
    wire_record = {
        "name": "wire_codec", "route": "cuda",
        "source": "src/repro_torch/kernels/wire_codec/wire_codec.cu",
        "replaces": "src/repro/kernels/wire_codec/wire_codec.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the round trip
        "composition_ms": main_t["composition_ms"],  # library top-k, then the pass
        "shape": main_t["shape"], "per_shape": timings,
        "train_codec_launches": train["codec_launches"],
        "train_codec_launches_sampled": sampled["launches"]["wire_codec"],
        "train_codec_launches_sharded": sharded["launches"]["wire_codec"],
        "train_shapes": train["codec_times"], "launch_floor": floor,
        "max_abs_err_train_shapes": train_errs,
    }
    main_b = blend_times[1]  # (17, 2097152): g_M/mix/w with the server head
    blend_record = {
        "name": "blend_params", "route": "cuda",
        "source": "src/repro_torch/kernels/blendavg/blendavg.cu",
        "replaces": "src/repro/kernels/blendavg/blendavg.py:29",
        "launches": train["launches"], "max_abs_err": blend_err,
        "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": main_b["library_ms"],  # omega @ stacked (cuBLAS)
        "shape": main_b["shape"], "per_shape": blend_times,
        "launches_sampled_rounds": sampled["launches"]["blend_params"],
        "launches_sharded_rounds": sharded["launches"]["blend_params"],
        "launches_baselines": {k: v["blend_launches"]
                               for k, v in baselines["runs"].items()},
        "full_round": round_blends,
    }
    main_s = slstm_times[-1]  # (64, 4, 64, 256): a full capacity batch
    slstm_record = {
        "name": "slstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/slstm_cell/slstm_cell.cu",
        "replaces": "src/repro/kernels/slstm_cell/slstm_cell.py:73",
        "launches": variants["recurrent"]["launches"],
        "launches_xlstm_serving": lm["launches"]["slstm_cell"],
        "max_abs_err": max(*slstm_err.values(), slstm_state_err),
        "ms": main_s["ms"], "plain_ms": main_s["plain_ms"],
        "bound_ms": main_s["bound_ms"], "bound_by": main_s["bound_by"],
        "library_ms": None,  # no single PyTorch call runs the recurrence
        "shape": main_s["shape"], "per_shape": slstm_times + slstm_state_times,
        "max_abs_err_by_dtype": slstm_err,
    }
    flash_time = flash_times[0]  # (64, 4, 64, 256) f32: the serving shape
    flash_record = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82",
        "launches": variants["transformer"]["launches"],
        "max_abs_err": max(flash_err.values()),
        "ms": flash_time["ms"], "plain_ms": flash_time["plain_ms"],
        "bound_ms": flash_time["bound_ms"], "bound_by": flash_time["bound_by"],
        "library_ms": flash_time["library_ms"],  # scaled_dot_product_attention
        "shape": flash_time["shape"], "per_case": flash_times,
        "max_abs_err_by_dtype": flash_err,
    }
    mlstm_record = {
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_scan/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan/mlstm_scan.py:71",
        "launches": lm["launches"]["mlstm_scan"], "max_abs_err": mlstm_err,
        "ms": mlstm_time["ms"], "plain_ms": mlstm_time["plain_ms"],
        "bound_ms": mlstm_time["bound_ms"], "bound_by": mlstm_time["bound_by"],
        "bound_ms_simt": mlstm_time["bound_ms_simt"],
        "engine": mlstm_time["engine"], "plan": mlstm_time["plan"],
        "ptxas": mlstm_time["ptxas"],
        "library_ms": None,  # no single PyTorch call computes the scan
        "shape": mlstm_time["shape"], "timing": mlstm_time,
        "max_abs_err_full_width": mlstm_main_errs,
    }
    print("baselines: " + json.dumps(
        {k: v for k, v in baselines.items() if k != "runs"}
        | {"runs": {name: {k: v for k, v in run.items() if k != "breakdown"}
                    for name, run in baselines["runs"].items()}}))
    print("sharded rounds: " + json.dumps(
        {label: {k: v for k, v in rec.items() if k != "breakdown"}
         for label, rec in sharded["runs"].items()}))
    print("variant training: " + json.dumps(
        {enc_type: {k: v for k, v in run.items() if k != "breakdown"}
         for enc_type, run in trained.items()}))
    bwd_records = []
    for name, enc_type, src, diff in (
            ("slstm_cell_bwd", "recurrent",
             "src/repro_torch/kernels/slstm_cell/slstm_cell_bwd.cu",
             "src/repro/models/recurrent.py:199"),
            ("flash_attention_bwd", "transformer",
             "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
             "src/repro/core/encoders.py:76")):
        t = bwd_times[name]
        bwd_records.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"none: the reference differentiates {diff} with jax.grad",
            "launches": trained[enc_type]["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # SDPA's memory-efficient backward for attention; no PyTorch
            # call runs the sLSTM's BPTT
            "library_ms": t["library_ms"],
            "shape": t["shape"], "device_ms": t["device_ms"],
            "library_max_abs_err": t.get("library_max_abs_err"),
            "round_wall_s": trained[enc_type]["round_wall_s"]})
    for record in (slstm_record, flash_record):  # the forwards training runs
        errs = {k.split()[1]: v for k, v in bwd_times["forward_errs"].items()
                if k.startswith(record["name"] + " ")}
        record["max_abs_err_training_shapes"] = errs
        record["max_abs_err"] = max(record["max_abs_err"], *errs.values())
    slstm_record["launches_training_round"] = trained["recurrent"]["launches"]["slstm_cell"]
    flash_record["launches_training_round"] = (
        trained["transformer"]["launches"]["flash_attention"])
    # the language models' serving (phases 23, 25): phi4-mini's prefill and
    # 32 steps, and each family's
    flash_record["launches_phi4_serving"] = (
        lm_runs["phi4-mini-3.8b"]["launches"]["flash_attention"])
    flash_record["launches_lm_families"] = {
        name: r["launches"]["flash_attention"] for name, r in lm_runs.items()}
    mlstm_record["launches_hymba_serving"] = (
        lm_runs["hymba-1.5b"]["launches"]["mlstm_scan"])
    # xlstm-350m training (phase 27): the 20 steps of the uninterrupted run
    mlstm_record["launches_lm_training"] = lm_train["launches"]["mlstm_scan"]
    slstm_record["launches_lm_training"] = lm_train["launches"]["slstm_cell"]
    bwd_records[0]["launches_lm_training"] = lm_train["launches"]["slstm_cell_bwd"]
    # the attention families' training (phases 29-31): the backward at
    # their shapes, and its launches in hymba's 12 steps and a step of each
    bwd_records[1]["lm_training_shapes"] = fbwd_lm
    bwd_records[1]["max_abs_err"] = max(
        bwd_records[1]["max_abs_err"],
        *(e for t in fbwd_lm.values() for e in t["max_abs_err"].values()))
    bwd_records[1]["launches_hymba_training"] = hymba_train["launches"][
        "flash_attention_bwd"]
    bwd_records[1]["launches_a_step_families"] = {
        name: r["launches_a_step"]["flash_attention_bwd"]
        for name, r in family_train.items()}
    flash_record["launches_hymba_training"] = hymba_train["launches"]["flash_attention"]
    # the production variants (phase 33): bf16 at the entries' shapes, and
    # the launches of each entry's run (a call, or a decode step)
    flash_record["production_shapes"] = production["flash"]
    flash_record["max_abs_err"] = max(flash_record["max_abs_err"],
                                      *(t["max_abs_err"] for t in production["flash"]))
    flash_record["production_bound_share"] = max(
        t["bound_share_vs_plain"] for t in production["flash"])
    mlstm_record["max_abs_err"] = max(
        mlstm_record["max_abs_err"], *(e for key, errs in production["recurrent"].items()
                                       if key.startswith("mlstm")
                                       for e in errs.values()))
    slstm_record["max_abs_err"] = max(
        slstm_record["max_abs_err"], *(e for key, e in production["recurrent"].items()
                                       if key.startswith("slstm")))
    flash_record["launches_production"] = {
        f"{fam} x {shape}": e["launches"].get("flash_attention", 0)
        for fam, r in production["runs"].items()
        for shape, e in r["entries"].items() if "launches" in e}
    for rec, key in ((mlstm_record, "mlstm_scan"), (slstm_record, "slstm_cell")):
        rec["launches_production"] = {
            f"{fam} x {shape}": e["launches"][key]
            for fam, r in production["runs"].items()
            for shape, e in r["entries"].items() if e.get("launches", {}).get(key)}
    mlstm_record["launches_hymba_training"] = hymba_train["launches"]["mlstm_scan"]
    # the production variant's training (phase 34): each kernel's launches
    # a train_4k step of each family that ran (forwards twice under remat)
    runs_4k = {n: r for n, r in train_4k["runs"].items() if r["status"] == "ok"}
    for rec, key in ((flash_record, "flash_attention"), (mlstm_record, "mlstm_scan"),
                     (slstm_record, "slstm_cell")):
        rec["launches_a_train_4k_step"] = {
            n: r["launches_a_step"][key] for n, r in runs_4k.items()
            if key in r["launches_a_step"]}
    blend_record["launches_baselines_variants"] = {
        k: v["launches"]["blend_params"] for k, v in baselines["variants"].items()}
    t = mbwd_times["xlstm"]
    mlstm_bwd_record = {
        "name": "mlstm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_scan/mlstm_scan_bwd.cu",
        "replaces": "none: the reference differentiates "
                    "src/repro/models/recurrent.py:28 with jax.grad",
        "design": "chunk-parallel, 3xTF32 mma.sync: chunk summaries and "
                  "an in-place pass give the chunk-boundary states, each "
                  "chunk's two score matrices computed once, then the "
                  "chunks' outputs in 64-column tiles and dlog_f's scan",
        "launches": lm_train["launches"]["mlstm_scan_bwd"],
        "launches_a_step": TRAIN_LAUNCHES["mlstm_scan_bwd"],
        "kernels_a_call": t["kernels_a_call"], "max_abs_err": mbwd_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bound_ms_simt": t["bound_ms_simt"],
        "library_ms": None,  # no single PyTorch call runs the scan's backward
        "autograd_ms": t["autograd_ms"], "device_ms": t["device_ms"],
        "shape": t["shape"], "hymba": mbwd_times["hymba"],
        "max_abs_err_by_shape": mbwd_errs,
        "launches_hymba_training": hymba_train["launches"]["mlstm_scan_bwd"],
        "train_4k_shapes": train_4k["mlstm_bwd"]}
    for rec, key in ((bwd_records[0], "slstm_cell_bwd"),
                     (bwd_records[1], "flash_attention_bwd"),
                     (mlstm_bwd_record, "mlstm_scan_bwd")):
        rec["launches_a_train_4k_step"] = {
            n: r["launches_a_step"][key] for n, r in runs_4k.items()
            if key in r["launches_a_step"]}
    bwd_records[1]["train_4k_shapes"] = train_4k["flash_bwd"]
    bwd_records[1]["max_abs_err"] = max(
        bwd_records[1]["max_abs_err"],
        *(e for t in train_4k["flash_bwd"].values() for e in t["max_abs_err"].values()))
    print("xlstm-350m training: " + json.dumps(
        {k: v for k, v in lm_train.items() if k != "breakdown"}))
    print("hymba-1.5b training: " + json.dumps(
        {k: v for k, v in hymba_train.items() if k != "breakdown"}))
    print("attention families' training: " + json.dumps(family_train))
    print("attention families' training card vs CPU: " + json.dumps(family_card_cpu))
    print(json.dumps({"kernels": [wire_record, blend_record, slstm_record,
                                  flash_record, mlstm_record, *bwd_records,
                                  mlstm_bwd_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
