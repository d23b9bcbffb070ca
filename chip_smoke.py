#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Runs from the repository root (it imports ``src/repro_torch``) and needs
one CUDA card; it exits non-zero, printing no result, without one or
outside a checkout. Phases, each fatal on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout, one
   nvcc per source, all at once;
3. wire codec against plain: the kernel's wrapper on tensors on the card,
   held against its plain PyTorch version (serving shapes, ragged N, an
   all-zero row, ties at the threshold, bf16, every codec, the features
   the full-width encoders produce, and the message shapes of a full
   and of a K = 4 sampled training round, whose rows span more blocks
   than the kernel's capped grid),
   then timed with CUDA events beside the plain version and the HBM
   bound, and at its least work, one row of 32 entries (the launch
   floor);
4. full-width serving: the ``ServingEngine`` (int8_topk codec) over three
   request mixes on the widest BlendFL model the repository supports
   (MLP encoders, d_hidden=1024, 4 layers, 64x128 features per modality,
   25 labels), with weights from a seed; scores checked for range, route,
   agreement with single-request ``predict`` and with the CPU run of the
   same models, and the wire bytes against the analytic cost; kernel
   launch counts read around this run (3 wire-codec launches a VFL
   micro-batch, none of any other kernel);
5. the CLI: ``repro_torch.launch.serve_federated --selftest`` serving a
   federation it trains inline on the card (2 rounds, 3 clients);
6. blend kernel against plain: the BlendAvg blend on the card against its
   plain version at the test shapes, the training round's leaf shapes
   and a K = 4 sampled round's ((4, 1,048,576), (5, 2,097,152),
   (4, 2,097,152), (5, 262,144)), a zero omega and bf16, then timed
   beside the plain version, the library call ``omega @ stacked`` and
   the HBM bound;
7. full-width training: BlendFL rounds (Algorithm 1 with BlendAvg, SGD)
   of 16 clients on the same model width, 8192 training rows: phase
   seconds, finite losses, omegas, blend launches of exactly one per
   leaf of each group that blended, one round's blend held against the
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
   (d_hidden=1024, 4 heads of 256; phase 4's set-up and checks, the
   CPU comparison on the first requests of each mix): each encoder
   kernel launches exactly once per encoder application (2 per
   multimodal or VFL micro-batch, 1 per unimodal one), a profiled mix;
   for the recurrent encoder, its card-vs-CPU difference layer by layer
   on the fixed streams' VFL rows (input layer, the sLSTM's input
   projection, its h sequence, the feature, the kernel alone);
12. the CLI: ``serve_federated --selftest --train-rounds 0`` with each of
   the two encoders, on the card;
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
   (24 layers, d_model 1024, random weights from seed 0): prefill of
   8 x 512 tokens and 32 greedy decode steps, exactly 12 mLSTM + 12 sLSTM
   launches in prefill and 0 + 12 in each decode step and no other
   kernel, prefill against ``forward``, a profiled prefill and step;
16. xlstm-350m card against CPU: prefill of 2 x 128 tokens and 4 decode
   steps, logits and caches within a stated tolerance;
17. full-width sampled and strategy rounds: phase 7's federation at K = 4
   of its 16 clients: 3 async BlendAvg rounds (uniform policy; wall time
   beside phase 7's full round, ids, staleness, ``last_round`` moving
   only at the participants, finite losses, one blend launch a leaf of
   each group that blended) and a profiled one, a round under each other
   policy, a round of each strategy and server optimizer (fedavg,
   fedprox, scaffold, fedavg with adam and with momentum, median and
   trimmed_mean launching no blend, krum one a leaf) with its peak
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
   ``int8_topk`` round; finite losses, one blend launch a leaf every
   round, one codec launch a leaf each way, no other kernel;
19. the training CLI on the card, in a child process that sets
   ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts: ``--selftest-resume``
   on the Makefile's eight resume lanes under deterministic algorithms
   (bit for bit, the same launches every round of every leg), a
   full-width checkpointed run of 4 rounds resumed to 6 by a second
   invocation, ``import`` and a store-backed run, and
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
   (30 a round for the HFL five, 26 for One-Shot VFL, none for SplitNN
   and centralized), peak memory, the six metrics each NaN or in [0, 1];
   FedAvg and SplitNN timed again and profiled (busy, idle share, the
   kernels that take most); FedAvg's blends against the plain version, FedMA's matching seconds
   and one (1024, 1024) matching against a numpy copy of the reference's
   loop, and a matched member with its hidden units shuffled through
   ``_match_encoder`` on the card against the loop's permutation; then FedAvg,
   FedNova, SplitNN and One-Shot VFL at phase 8's width, card against CPU
   from the same weights (params at phase 8's tolerance, metrics within
   EVAL_ATOL).

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

import json
import subprocess
import sys
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

FP32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores (dense)
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
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

# Timed kernels read inputs rotated over at least this many bytes, so
# that a launch finds its input in HBM, not in the 50 MB L2, as a
# round's blend does.
ROTATE_BYTES = 200e6


def hbm_bytes_per_s(name: str) -> float:
    """Device memory rate of the card (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


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


def device_kernels(run) -> list:
    """Profile one call of ``run``: [(device us, calls, name)] of every
    kernel and copy it put on the card, largest first. Once this script
    has run its first phases, a profile can lose the first launch or two
    it sees (a profile of one flash launch recorded none, one of 50
    recorded 49), so each profile starts with a warm-up step of small
    kernels whose events the profiler's schedule discards."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(16):
            scratch.add_(1.0)
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends: record from here
        run()
        torch.cuda.synchronize()
        prof.step()
    return sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)


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


def device_ms(fn, iters=50, label=""):
    """Device time per call of ``fn`` (every kernel and copy it puts on
    the card) from the profiler, or None when the profiler recorded no
    device time or dropped events; the latter is printed."""
    fn()
    one = device_kernels(fn)
    many = device_kernels(lambda: [fn() for _ in range(iters)])
    ms, dropped = per_call_device_ms(one, many, iters)
    if dropped:
        print(f"profiler dropped events{' (' + label + ')' if label else ''}: "
              f"launches recorded / expected "
              f"{ {name[:60]: c for name, c in dropped.items()} }; "
              "device time not reported")
    return ms


def device_breakdown(run, wall_s, top=6, match=()):
    """The device's busy time in one call of ``run`` (kernels and copies),
    its idle share of ``wall_s`` (the same work timed without the
    profiler), the kernels that take most, and the time and calls of the
    kernels whose names hold each string of ``match``."""
    kernels = device_kernels(run)
    busy_s = sum(k[0] for k in kernels) / 1e6
    return {"busy_ms": busy_s * 1e3, "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy_s / wall_s,
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
    # downlink (1, leaf) at k = a quarter of the row, in f32 and bf16; a 1M-wide row
    # needs 4096 blocks of 256 threads, so the kernel's grid (capped at 256
    # blocks a row) loops over each row 16 times
    for l, n in TRAIN_CODEC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = rows(l, n).to(dtype)
            for codec, (kk, q) in codecs.items():
                cases.append((f"train_{l}x{n}_{str(dtype)[6:]}/{codec}", x,
                              n // 4 if kk else None, q))
    return cases


def check_kernel(torch, ops, launcher, ref, x, k, quantize):
    st = ops.scale_thresh(x, k)
    got = launcher.wire_codec_cuda(x.contiguous(), st, quantize=quantize)
    want = ref.wire_codec_ref(x, st, quantize=quantize)
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    check(torch.equal(g != 0, w != 0), "keep-masks differ")
    scale = st[:, :1]
    err = float((g - w).abs().max())
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


def time_codec(torch, ops, launcher, ref, x, k, mem_rate):
    st = ops.scale_thresh(x, k)
    xc = x.contiguous()
    ms = cuda_time_ms(lambda: launcher.wire_codec_cuda(xc, st, quantize=True))
    plain_ms = cuda_time_ms(lambda: ref.wire_codec_ref(xc, st, quantize=True))
    roundtrip_ms = cuda_time_ms(
        lambda: ops.wire_codec_roundtrip(xc, k=k, quantize=True))
    kernel_device_ms = device_ms(
        lambda: launcher.wire_codec_cuda(xc, st, quantize=True))
    plain_device_ms = device_ms(
        lambda: ref.wire_codec_ref(xc, st, quantize=True))
    rows, n = x.shape
    nbytes = rows * n * 2 * x.element_size() + rows * 8
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = CODEC_OPS_PER_ELEM * rows * n / FP32_OPS_PER_S * 1e3
    return {"shape": [rows, n], "dtype": str(x.dtype).replace("torch.", ""),
            "k": k, "ms": ms, "plain_ms": plain_ms,
            "roundtrip_ms": roundtrip_ms, "device_ms": kernel_device_ms,
            "plain_device_ms": plain_device_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def time_train_codec(torch, ops, wlaunch, wref, rows, n, mem_rate):
    """The wire codec at one training message shape (k = a quarter of
    the row, the codec's default topk_frac): kernel and plain version
    given [scale, thresh], and the whole round-trip with its top-k."""
    from repro_torch.core.codec import topk_k

    k = topk_k(n, 0.25)
    nbytes = rows * n * 4

    def make():
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (rows, n), np.float32)).cuda()
        return x, ops.scale_thresh(x, k)

    nxt = rotation(make, nbytes)
    ms = cuda_time_ms(lambda: wlaunch.wire_codec_cuda(*nxt(), quantize=True),
                      iters=50, warmup=3)
    plain_ms = cuda_time_ms(lambda: wref.wire_codec_ref(*nxt(), quantize=True),
                            iters=50, warmup=3)
    roundtrip_ms = cuda_time_ms(lambda: ops.wire_codec_roundtrip(
        nxt()[0], k=k, quantize=True), iters=20, warmup=2)
    kernel_device_ms = device_ms(
        lambda: wlaunch.wire_codec_cuda(*nxt(), quantize=True), iters=20)
    bytes_ms = (nbytes * 2 + rows * 8) / mem_rate * 1e3
    ops_ms = CODEC_OPS_PER_ELEM * rows * n / FP32_OPS_PER_S * 1e3
    return {"shape": [rows, n], "dtype": "float32", "k": k, "ms": ms,
            "plain_ms": plain_ms, "roundtrip_ms": roundtrip_ms,
            "device_ms": kernel_device_ms, "bound_ms": max(bytes_ms, ops_ms),
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
        want = sum(leaves[m] for m in groups)
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
    want = sum(leaves[m] for m in blended(logs))
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
        print(f"wire_codec {t['shape']} k={t['k']}: kernel {t['ms']:.5f} ms "
              f"(device {t['device_ms']} ms), plain {t['plain_ms']:.5f} ms, "
              f"roundtrip with top-k {t['roundtrip_ms']:.5f} ms; bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
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


def card_vs_cpu(torch, rounds=2, data_seed=0, **kw) -> dict:
    """Phase 8: the quickstart-shaped federation on the card and on the
    CPU, from the same weights and shuffles (both draw them from
    CPU generators seeded alike), held to the CPU parity tolerances;
    ``kw`` goes to ``FedConfig`` (3 clients unless it says otherwise),
    ``data_seed`` to the data.
    A sampled round's ids must be equal on both. The smallest BlendAvg
    delta of the CPU run is printed: a delta within the card's rounding
    of 0 could flip an omega mask (ROADMAP fault (d)). After an adam
    server step the params' atol is scaled by server_lr / SERVER_EPS, the
    step's largest gain on a small delta. SCAFFOLD's control variates are
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
    ecfg = EncoderConfig(d_hidden=48, n_layers=2)
    feds = [Federation.init(torch.Generator().manual_seed(0), cfg, spec, ecfg,
                            clients, va, device=dev) for dev in ("cuda", "cpu")]
    weights, margins = fed_mod.blendavg_weights, []

    def recording(scores, global_score, **k):  # the CPU run's deltas
        d = np.asarray(scores, np.float64) - global_score
        margins.append(float(np.abs(d[np.isfinite(d)]).min(initial=np.inf)))
        return weights(scores, global_score, **k)

    worst = {"loss": 0.0, "omega": 0.0}
    sampled = []
    for r in range(cfg.rounds):
        card = feds[0].round()
        fed_mod.blendavg_weights = recording
        try:
            cpu = feds[1].round()
        finally:
            fed_mod.blendavg_weights = weights
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
            check(all(np.allclose(a, b, rtol=PARAM_RTOL, atol=tol)
                      for a, b in pairs),
                  f"{name}: card vs CPU beyond tolerance")
    for f in feds[1:]:
        check(np.array_equal(feds[0].last_round, f.last_round)
              and np.array_equal(feds[0].part_count, f.part_count),
              "last_round / part_count differ card vs CPU")
    ea, eb = (evaluate_global(f, te) for f in feds)
    worst["eval"] = max(abs(ea[k] - eb[k]) for k in ea)
    if not lossy:
        check(worst["eval"] <= EVAL_ATOL, f"evaluate_global: card {ea} cpu {eb}")
    print(f"card vs CPU, {cfg.rounds} round(s), {kw or 'blendavg'}: "
          f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} }; "
          f"multimodal AUROC {ea['multimodal_auroc']:.4f}; smallest BlendAvg "
          f"delta {min(margins, default=float('nan')):.3g}"
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
    """Blend launches a round should make: one a leaf of each group that
    blended. BlendAvg blends a group where some omega is positive; the
    weighted strategies and krum blend every group that ran (fedavg's
    path blends, then keeps the global where no weight is positive);
    median and trimmed_mean reduce by order statistics and blend none."""
    scfg = fed.engine.cfg.strategy
    if scfg.name in ("median", "trimmed_mean"):
        return 0
    if scfg.score_based:
        return sum(leaves[m] for m in blended(logs))
    return sum(leaves[m] for m in "ABM" if f"omega_{m}" in logs)


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
          f"{bd['wall_ms']:.2f} ms wall, idle share {bd['idle_share']:.3f}")
    for k in bd["top"]:
        print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x {k['kernel']}")


def full_width_serving(torch, spec, ecfg, models, gmv, launchers,
                       seed=0) -> dict:
    """Serve the three mixes (64 requests of 1..64 rows each, streams
    fixed by ``seed`` and MIX_SALT) through one ``ServingEngine``
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
    rows_by_mix = {mix: sf.serve_mix(engine, spec, mix, 64, rows=64, seed=seed,
                                     salt=MIX_SALT[mix])
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
        reqs = sf.make_requests(spec, mix, 64, rows=64, seed=seed,
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


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs of one head that the masks let through."""
    qi = np.arange(sq)[:, None] + (sk - sq)
    ki = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask = ki <= qi
    if window > 0:
        mask &= ki > qi - window
    return int(mask.sum())


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

    def sdpa():  # the library yardstick: timed here, never on the path
        return F.scaled_dot_product_attention(*nxt(), is_causal=causal,
                                              enable_gqa=hq != hkv)

    check(window == 0 and (not causal or sq == sk),
          "SDPA's causal mask is end-aligned only when Sq == Sk, no window")
    out = {"shape": [b, hq, hkv, sq, sk, d], "causal": causal,
           "dtype": str(dtype)[6:], "ms": cuda_time_ms(kern),
           "library_ms": cuda_time_ms(sdpa),
           "device_ms": device_ms(kern, label=f"flash {tag}"),
           "library_device_ms": device_ms(sdpa, label=f"SDPA {tag}")}
    if plain:
        out["plain_ms"] = cuda_time_ms(plain_fn, iters=50)
        out["plain_device_ms"] = device_ms(plain_fn, label=f"flash plain {tag}")
    # bound: q, k, v read once and the output written once, over the
    # memory rate; 4*d operations (q.k and p*v) for each visible (query,
    # key) pair, over the peak of the inputs' type (f32 outside the
    # tensor cores, bf16 on them)
    bytes_ms = nbytes / mem_rate * 1e3
    ops = 4 * d * visible_pairs(sq, sk, causal, window) * b * hq
    peak = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
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
    causal GQA case, f32 and bf16, rows without a visible key), then
    timed at full width (f32, with the plain version; bf16) and at the
    long causal GQA case (f32, bf16), each beside
    scaled_dot_product_attention. Returns (max abs err by dtype, the
    timings, the f32 full-width one first)."""
    flash_err, n_cases = {}, 0
    for case in FLASH_TEST_CASES + FLASH_EDGE_CASES + (FLASH_MAIN, FLASH_LONG):
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
    del q, k, v, got
    print(f"{n_cases} cases within tolerance of the plain version (f32 2e-5, "
          f"bf16 2e-2), finite, rows without keys exactly 0; max abs err "
          f"{flash_err}")
    times = [time_flash(torch, flaunch, fref, FLASH_MAIN, mem_rate),
             time_flash(torch, flaunch, fref, FLASH_MAIN, mem_rate,
                        dtype=torch.bfloat16, plain=False),
             time_flash(torch, flaunch, fref, FLASH_LONG, mem_rate, plain=False),
             time_flash(torch, flaunch, fref, FLASH_LONG, mem_rate,
                        dtype=torch.bfloat16, plain=False)]
    for t in times:
        plain = (f", plain {t['plain_ms']:.5f} ms (device {t['plain_device_ms']} ms)"
                 if "plain_ms" in t else "")
        print(f"flash_attention {t['shape']} causal={t['causal']} {t['dtype']}: "
              f"kernel {t['ms']:.5f} ms (device {t['device_ms']} ms){plain}, SDPA "
              f"{t['library_ms']:.5f} ms (device {t['library_device_ms']} ms); "
              f"kernel / SDPA {t['vs_library']:.3f}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {t['bound_share']:.3f} of it")
    return flash_err, times


def recurrent_layers(torch, spec, ecfg, models, seed=0) -> dict:
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
            for req in sf.make_requests(spec, mix, 64, rows=64, seed=seed,
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


def variant_serving(torch, spec, enc, sf, counted) -> dict:
    """Phase 11: full-width serving (phase 4's set-up and checks) with
    the recurrent, then the transformer encoders; each encoder kernel
    launches once per encoder application and the other not at all."""
    variants = {}
    for enc_type, own, symbol in (("recurrent", "slstm_cell", "slstm_kernel"),
                                  ("transformer", "flash_attention", "flash_kernel")):
        vcfg = enc.EncoderConfig(d_hidden=1024, n_layers=4, enc_type=enc_type,
                                 n_heads=4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        vmodels = enc.init_client_models(gen, spec, vcfg, device="cuda")
        vgmv = enc.fusion_init(gen, vcfg.d_hidden, spec.out_dim, device="cuda")
        print(f"-- {enc_type}: d_hidden 1024, 4 heads of 256")
        res = full_width_serving(torch, spec, vcfg, vmodels, vgmv, counted)
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
            layers = recurrent_layers(torch, spec, vcfg, vmodels)
            flipped = res["tolerance"]["engine vs cpu (int8_topk routes)"]["flipped"]
            print("recurrent encoder card vs CPU, max abs difference by layer "
                  "(VFL rows of the fixed streams): " + ", ".join(
                      f"{k} {v:.3g}" for k, v in layers.items())
                  + f"; rows with differing wire messages {flipped:.5f}")
            res["layers_card_vs_cpu"] = layers
        engine = res.pop("engine")
        bd = device_breakdown(
            lambda: sf.serve_mix(engine, spec, "all_multimodal", 64, rows=64,
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


def variant_cli(sf, slaunch, flaunch):
    """Phase 12: the CLI selftest on seeded recurrent and transformer
    models, on the card."""
    for enc_type, mod in (("recurrent", slaunch), ("transformer", flaunch)):
        mod.launches = 0
        sf.main(["--selftest", "--enc-type", enc_type, "--train-rounds", "0",
                 "--codec", "int8_topk", "--device", "cuda"])
        check(mod.launches > 0, f"CLI selftest ({enc_type}) launched no kernel")
        print(f"CLI selftest ({enc_type}): {mod.launches} launches")


# ------------------------------------------------- mLSTM and xlstm-350m --

# (b, h, s, dk, dv, chunk): the CPU tests' shapes (tests/test_kernels.py),
# a ragged S at the model's chunk, then xlstm-350m's mLSTM at full width
# (8 sequences of 512 tokens, 4 heads of dk = dv = 512, chunk 64)
MLSTM_TEST_CASES = ((1, 2, 64, 16, 16, 16), (2, 3, 100, 32, 16, 32),
                    (1, 1, 128, 64, 64, 128), (2, 4, 77, 512, 512, 64))
MLSTM_MAIN = (8, 4, 512, 512, 512, 64)
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
    full width; normalize on and off; h, C and n), then timed at full
    width beside the plain version and the bound at both f32-accurate
    rates: three TF32 products for each f32 one on the tensor cores (495
    TFLOP/s), as the kernel runs them, which is the lower and so the
    bound (``bound_ms``), and f32 on SIMT (67 TFLOP/s, ``bound_ms_simt``).
    Returns (max abs err, errors at full width, timing)."""
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
    for case in MLSTM_TEST_CASES + (MLSTM_MAIN,):
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
    nbytes = 4 * b * h * (s * (2 * dk + 2 * dv + 1) + dk * dv + dk)
    nxt = rotation(lambda: mlstm_inputs(torch, b, h, s, dk, dv, seed=1), nbytes)

    def kern():
        return mlaunch.mlstm_scan_cuda(*nxt(), chunk=chunk, return_state=True)

    def plain():
        return mref.mlstm_scan_ref(*nxt(), return_state=True)

    flops = mlstm_flops(b, h, s, dk, dv, chunk)
    bytes_ms = nbytes / mem_rate * 1e3
    ops_ms = min(3 * flops / TF32_OPS_PER_S, flops / FP32_OPS_PER_S) * 1e3
    t = {"shape": list(MLSTM_MAIN[:5]), "chunk": chunk,
         "ms": cuda_time_ms(kern, iters=20, warmup=3),
         "device_ms": device_ms(kern, iters=10, label="mlstm"),
         "plain_ms": cuda_time_ms(plain, iters=3, warmup=1),
         "plain_device_ms": device_ms(plain, iters=2, label="mlstm plain"),
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "bound_ms_simt": max(bytes_ms, flops / FP32_OPS_PER_S * 1e3),
         "engine": "tensor cores: mma.sync m16n8k8 TF32, 3xTF32 split",
         "gflop": flops / 1e9, "plan": vars(plan), "active_clusters": active,
         "ptxas": regs}
    print(f"mlstm_scan {t['shape']} chunk {chunk}: kernel {t['ms']:.5f} ms "
          f"(device {t['device_ms']} ms), plain {t['plain_ms']:.5f} ms (device "
          f"{t['plain_device_ms']} ms); bound {t['bound_ms']:.6f} ms in 3xTF32 "
          f"on the tensor cores ({t['bound_by']}, {t['gflop']:.2f} GFLOP), "
          f"{t['bound_ms_simt']:.6f} ms in f32 on SIMT; kernel at "
          f"{t['bound_ms'] / t['ms']:.3f} / {t['bound_ms_simt'] / t['ms']:.3f} "
          "of them")
    return worst, main_errs, t


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


def lm_serving(torch, counted) -> dict:
    """Phase 15: xlstm-350m at full width through serve_lm on the card:
    prefill of LM_BATCH x LM_PROMPT tokens and LM_GEN greedy decode
    steps, launches counted per stage (12 mLSTM + 12 sLSTM in prefill,
    0 + 12 in each decode step, nothing else), prefill against forward,
    a decode step against forward on the extended sequence, and a
    profiled prefill and decode step."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import backbone as bb

    cfg = get_config("xlstm_350m")
    n_pairs = bb.n_scan_layers(cfg)
    params = bb.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"xlstm-350m: {cfg.n_layers} layers ({n_pairs} pairs), d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters "
          f"({n_params * 4 / 1e9:.3f} GB f32)")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
                              .astype(np.int32)).cuda()
    max_len = LM_PROMPT + LM_GEN
    serve_lm.generate(params, cfg, tokens[:, :64], gen=2, max_len=max_len)  # warm-up

    stages = []

    def hook(stage, i):
        stages.append((stage, {k: m.launches for k, m in counted.items()}))
        for m in counted.values():
            m.launches = 0

    for m in counted.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.generate(params, cfg, tokens, gen=LM_GEN, max_len=max_len,
                            hook=hook)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_prefill = {k: 0 for k in counted}
    want_prefill.update(mlstm_scan=n_pairs, slstm_cell=n_pairs)
    want_decode = dict(want_prefill, mlstm_scan=0)
    check(stages[0] == ("prefill", want_prefill),
          f"prefill launches {stages[0]}, want {want_prefill}")
    check(len(stages) == 1 + LM_GEN and all(
        got == ("decode", want_decode) for got in stages[1:]),
        f"decode launches {stages[1:3]}..., want {want_decode} each step")
    total = {k: sum(c[k] for _, c in stages) for k in counted}
    steps = np.asarray(res["decode_s"])
    out = {"n_params": n_params, "launches": total,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms_per_step": float(steps.mean() * 1e3),
           "decode_ms_median": float(np.median(steps) * 1e3),
           "tokens_per_s": LM_BATCH * LM_GEN / float(steps.sum()),
           "peak_gb": peak_gb}
    toks = res["tokens"]
    check(tuple(toks.shape) == (LM_BATCH, 1 + LM_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generated tokens out of range")
    print(f"serve_lm: prefill {LM_PROMPT} tokens x{LM_BATCH} "
          f"{out['prefill_ms']:.3f} ms; {LM_GEN} decode steps "
          f"{steps.sum() * 1e3:.3f} ms ({out['tokens_per_s']:.1f} tokens/s, "
          f"{out['decode_ms_per_step']:.3f} ms a step, median "
          f"{out['decode_ms_median']:.3f}); peak memory {peak_gb:.3f} GB")
    print(f"prefill: {stages[0][1]['mlstm_scan']} mlstm_scan + "
          f"{stages[0][1]['slstm_cell']} slstm_cell launches, nothing else; each "
          f"decode step: 0 + {n_pairs}")

    with torch.no_grad():
        logits, cache, idx = bb.prefill(params, cfg, {"tokens": tokens}, max_len)
        for m in counted.values():
            m.launches = 0
        full, _ = bb.forward(params, cfg, {"tokens": tokens})
        fwd_launches = {k: m.launches for k, m in counted.items()}
        a, b = logits[:, 0], full[:, -1]
        out["prefill_vs_forward"] = float((a - b).abs().max())
        check(bool(torch.isfinite(full).all()) and torch.allclose(
            a, b, atol=LM_PREFILL_TOL, rtol=LM_PREFILL_TOL),
            f"prefill vs forward: {out['prefill_vs_forward']}")
        del full
        nt = toks[:, 1:2]
        lg2, _ = bb.decode_step(params, cfg, nt, cache, idx)
        full2, _ = bb.forward(params, cfg, {"tokens": torch.cat([tokens, nt], 1)})
        out["decode_vs_forward"] = float((lg2[:, 0] - full2[:, -1]).abs().max())
        check(torch.allclose(lg2[:, 0], full2[:, -1], atol=LM_DECODE_TOL,
                             rtol=LM_DECODE_TOL),
              f"decode step vs forward: {out['decode_vs_forward']}")
        del full2
    print(f"forward: {fwd_launches['mlstm_scan']} mlstm_scan + "
          f"{fwd_launches['slstm_cell']} slstm_cell launches")
    print(f"prefill vs forward last logits: max abs err "
          f"{out['prefill_vs_forward']:.3g} (tol {LM_PREFILL_TOL}); decode step "
          f"vs forward on the extended sequence: {out['decode_vs_forward']:.3g} "
          f"(tol {LM_DECODE_TOL})")

    with torch.no_grad():
        bd_p = device_breakdown(
            lambda: bb.prefill(params, cfg, {"tokens": tokens}, max_len),
            res["prefill_s"], match=("mlstm_kernel", "slstm_kernel"))
        bd_d = device_breakdown(
            lambda: bb.decode_step(params, cfg, nt, cache, idx),
            float(np.median(steps)), match=("mlstm_kernel", "slstm_kernel"))
    print_breakdown("prefill", bd_p)
    print_breakdown("decode step", bd_d)
    for label, bd in (("prefill", bd_p), ("decode step", bd_d)):
        print(f"    {label}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms in {v['calls']}" for k, v in bd["matched"].items()))
    out["breakdown"] = {"prefill": bd_p, "decode": bd_d}
    return out, params


def lm_card_vs_cpu(torch, params) -> dict:
    """Phase 16: xlstm-350m at full width on the card and on the CPU from
    the same weights: prefill of 2 x 128 tokens, then 4 decode steps fed
    the card's greedy tokens; logits and caches within LM_CPU_TOL."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import backbone as bb

    cfg = get_config("xlstm_350m")
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    worst = {}

    def compare(name, a, b):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            x, y = x.cpu(), y.cpu()
            err = float((x - y).abs().max())
            worst[name] = max(worst.get(name, 0.0), err)
            check(torch.allclose(x, y, atol=LM_CPU_TOL, rtol=LM_CPU_TOL),
                  f"card vs CPU {name}: max abs err {err}")

    with torch.no_grad():
        runs = []
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            toks = torch.from_numpy(tokens).to(dev)
            runs.append(bb.prefill(p, cfg, {"tokens": toks}, 128 + 4))
        (lc, cc, idx), (lg, cg, _) = runs
        compare("logits", lc, lg)
        compare("cache/m", cc["m"], cg["m"])
        compare("cache/s", cc["s"], cg["s"])
        for i in range(4):
            nt = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
            lc, cc = bb.decode_step(params, cfg, nt, cc, idx + i)
            lg, cg = bb.decode_step(cpu_params, cfg, nt.cpu(), cg, idx + i)
            compare("logits", lc, lg)
        compare("cache/m", cc["m"], cg["m"])
        compare("cache/s", cc["s"], cg["s"])
    print(f"card vs CPU, xlstm-350m, prefill 2 x 128 + 4 decode steps: max abs "
          f"err {worst} (tol atol = rtol = {LM_CPU_TOL})")
    return worst


# Phase 18: the reference's widest BlendFL entry (src/repro/launch/
# specs.py, make_blendfl_entry) with AdamW, over phase 7's partition.
SHARDED_SPEC = dict(n_clients=16, d_hidden=1024, n_layers=4, seq_a=64,
                    feat_a=128, seq_b=64, feat_b=128, out_dim=25,
                    kind="multilabel", n_partial=512, n_frag=512,
                    n_paired=512, n_val=2048, n_val_score=512,
                    optimizer="adamw")
SHARDED_K = 4


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
    from repro_torch.core.federation_sharded import (ShardedFedSpec,
                                                     batch_specs,
                                                     init_round_state,
                                                     make_blendfl_round)
    from repro_torch.core.schedule import telemetry_from_state
    from repro_torch.data.pipeline import FederatedBatcher
    from repro_torch.launch.train_federated import client_arrays

    t0 = time.perf_counter()
    clients, va, te = training_data(spec)
    arrays = [client_arrays(c) for c in clients]
    val = {"val_a": np.concatenate([va.x_a, te.x_a]),
           "val_b": np.concatenate([va.x_b, te.x_b]),
           "val_y": np.concatenate([va.y, te.y])}
    base = ShardedFedSpec(**SHARDED_SPEC)
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
            want["blend_params"] = n_leaves  # every group blends, a leaf a launch
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
                top=8, match=("blend_kernel", "wire_codec"))
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
    first = tf.main(full + ["--rounds", "4", "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    second = tf.main(full + ["--rounds", "6", "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    print(f"    checkpointed run: rounds {[r['round'] for r in first]} then, "
          f"resumed, {[r['round'] for r in second]} in "
          f"{time.perf_counter() - t0:.2f} s; launches a round "
          f"{[r['launches'] for r in first + second]}", flush=True)
    check([r["round"] for r in first] == [0, 1, 2, 3]
          and [r["round"] for r in second] == [4, 5], "checkpointed run rounds")
    check(all(r["launches"] == {"blend_params": 30, "wire_codec": 0}
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


def greedy_match_numpy(ref, cand):
    """A numpy copy of the reference's FedMA matcher
    (``src/repro/core/baselines.py:270-283``), which this script may not
    import: n argmax passes over the masked similarity matrix."""
    n = ref.shape[0]
    sim = (ref / (np.linalg.norm(ref, axis=1, keepdims=True) + 1e-9)) @ (
        cand / (np.linalg.norm(cand, axis=1, keepdims=True) + 1e-9)).T
    perm = np.full(n, -1)
    used = np.zeros(n, bool)
    for _ in range(n):
        i, j = np.unravel_index(np.argmax(np.where(used[None, :], -np.inf,
                                                   np.where(perm[:, None] >= 0, -np.inf, sim))),
                                sim.shape)
        perm[i] = j
        used[j] = True
    return perm


def baseline_blends(name, clients, leaves, rounds) -> int:
    """Blend launches a baseline makes: one a leaf of each model group
    with members (f_A + g_A, f_B + g_B, g_M) every round of the HFL
    baselines (HFCL's pooled client holds a modality iff a data-sharing
    client does, so its groups are those of all clients); One-Shot VFL
    blends f + g of A and B once; SplitNN and centralized none."""
    has = {"A": any(c.has_a for c in clients), "B": any(c.has_b for c in clients),
           "M": any(c.has_paired for c in clients)}
    if name in ("splitnn", "centralized"):
        return 0
    if name == "oneshot_vfl":
        return sum(leaves[m] for m in "AB" if has[m])
    return rounds * sum(leaves[m] for m in "ABM" if has[m])


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
    ``w[:, perm]`` / ``b[perm]``; FedAvg and SplitNN
    timed again and profiled. Then FedAvg, FedNova, SplitNN and One-Shot VFL at phase 8's width on
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
    leaves = group_leaves(tree_leaves, init_client_models(
        torch.Generator().manual_seed(0), spec, ecfg, device="cpu"))
    check(leaves == {"A": 13, "B": 13, "M": 4}, f"leaves per group {leaves}")
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
        got, want = blaunch.launches, baseline_blends(name, clients, leaves, cfg.rounds)
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
    for name in ("fedavg", "splitnn"):
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


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--cli-child":
        return cli_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import encoders as enc
    from repro_torch.data.synthetic import TaskSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.blendavg import blendavg as blaunch
    from repro_torch.kernels.blendavg import ref as bref
    from repro_torch.kernels.flash_attention import flash_attention as flaunch
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mlaunch
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.kernels.slstm_cell import ref as sref
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch
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
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[p.name for p in libs]} in {time.perf_counter() - t0:.2f} s")
    for src in _build.sources():  # registers, stack and spills of each kernel
        for name, info in ptxas_summary(_build.report(src)):
            print(f"{src.name}: {name}: {info}")

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
        print(f"wire_codec {t['shape']} k={t['k']}: kernel {t['ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, roundtrip {t['roundtrip_ms']:.5f} "
              f"ms; device {t['device_ms']} ms, plain device "
              f"{t['plain_device_ms']} ms; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")
    print(f"wire_codec launch floor: {floor['ms']:.5f} ms a call, device "
          f"{floor['device_ms']} ms at (1, 32); (64, 1024): {timings[2]['ms']:.5f} "
          f"ms, device {timings[2]['device_ms']} ms")

    phase("4 full-width serving")
    counted = {"wire_codec": launcher, "blend_params": blaunch,
               "slstm_cell": slaunch, "flash_attention": flaunch,
               "mlstm_scan": mlaunch}
    serve4 = full_width_serving(torch, spec, ecfg, models, gmv, counted)
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
    variant_cli(sf, slaunch, flaunch)

    phase("13 mLSTM scan against plain")
    mlstm_err, mlstm_main_errs, mlstm_time = mlstm_phase(
        torch, mlaunch, mref, mem_rate, ptxas_summary(_build.report(mlaunch.SOURCE)))

    phase("14 sLSTM cell with a state against plain")
    slstm_state_err, slstm_state_times = slstm_state_phase(torch, slaunch, sref,
                                                           mem_rate)

    phase("15 full-width xlstm-350m serving")
    lm, lm_params = lm_serving(torch, counted)

    phase("16 xlstm-350m card against CPU")
    lm["card_vs_cpu"] = lm_card_vs_cpu(torch, lm_params)
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
    baselines = baselines_phase(torch, spec, ecfg, data + (train.pop("test"),),
                                blaunch, bref)
    del data
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
        "library_ms": None,  # no single PyTorch call computes the fused pass
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
    print(json.dumps({"kernels": [wire_record, blend_record, slstm_record,
                                  flash_record, mlstm_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
