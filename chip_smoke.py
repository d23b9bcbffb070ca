#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Runs from the repository root (it imports ``src/repro_torch``) and needs
one CUDA card; it exits non-zero, printing no result, without one or
outside a checkout. Phases, each fatal on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, compiled from the checkout;
3. kernel against plain: each kernel's wrapper on tensors on the card,
   held against its plain PyTorch version (serving shapes, ragged N, an
   all-zero row, ties at the threshold, bf16, every codec, and the
   features the full-width encoders produce), then timed with CUDA
   events beside the plain version and the HBM bound;
4. full-width serving: the ``ServingEngine`` (int8_topk codec) over three
   request mixes on the widest BlendFL model the repository supports
   (MLP encoders, d_hidden=1024, 4 layers, 64x128 features per modality,
   25 labels), with weights from a seed; scores checked for range, route,
   agreement with single-request ``predict`` and with the CPU run of the
   same models, and the wire bytes against the analytic cost; kernel
   launch counts read around this run;
5. the CLI: ``repro_torch.launch.serve_federated --selftest``.

It then prints one JSON line of per-kernel numbers, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Kernel vs plain version: identical keep-masks and int8 codes, values
# within 4 * eps_f32 * scale_row, the dense identity exact. Engine vs
# predict and card vs CPU use the serving tolerance of
# repro_torch.launch.serve_federated (within_tolerance).
EPS32 = float(np.finfo(np.float32).eps)

FP32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
CODEC_OPS_PER_ELEM = 8  # abs, compare, mul, rint, max, min, mul, select


def hbm_bytes_per_s(name: str) -> float:
    """Device memory rate of the card (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


def phase(name):
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
    kernel and copy it put on the card, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)


def device_ms(fn, iters=50):
    """Device time per call of ``fn`` (every kernel it launches), or None
    when the profiler records no device time."""
    fn()
    total_us = sum(k[0] for k in device_kernels(
        lambda: [fn() for _ in range(iters)]))
    return total_us / iters / 1e3 if total_us > 0 else None


def device_breakdown(run, wall_s, top=6):
    """The device's busy time in one call of ``run`` (kernels and copies),
    its idle share of ``wall_s`` (the same work timed without the
    profiler), and the kernels that take most."""
    kernels = device_kernels(run)
    busy_s = sum(k[0] for k in kernels) / 1e6
    return {"busy_ms": busy_s * 1e3, "wall_ms": wall_s * 1e3,
            "idle_share": 1.0 - busy_s / wall_s,
            "top": [{"kernel": name[:70], "ms": us / 1e3, "calls": n}
                    for us, n, name in kernels[:top]]}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import encoders as enc
    from repro_torch.core.inference import (InferenceRequest, Route,
                                            communication_cost, predict,
                                            route_for)
    from repro_torch.core.serving import ServingConfig, ServingEngine
    from repro_torch.data.synthetic import TaskSpec
    from repro_torch.kernels import _build
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

    spec = TaskSpec("blendfl-1024", "multilabel", 25, 64, 128, 64, 128)
    ecfg = enc.EncoderConfig(d_hidden=1024, n_layers=4, enc_type="mlp")
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = enc.init_client_models(gen, spec, ecfg, device="cuda")
    gmv = enc.fusion_init(gen, ecfg.d_hidden, spec.out_dim, device="cuda")

    phase("3 kernel against plain")
    xg = np.random.default_rng(1)
    with torch.no_grad():
        feats = [enc.encoder_apply(models[f], torch.from_numpy(
            xg.standard_normal((64, 64, 128)).astype(np.float32)).cuda(), ecfg)
            for f in ("f_A", "f_B")]
    max_err = 0.0
    cases = kernel_cases(torch, feats)
    for label, x, k, quantize in cases:
        err = check_kernel(torch, ops, launcher, ref, x, k, quantize)
        max_err = max(max_err, err)
    print(f"{len(cases)} cases match the plain version; max abs err {max_err:.3g}")
    timings = [time_codec(torch, ops, launcher, ref, x, k, mem_rate)
               for x, k in ((feats[0][:2].contiguous(), 256),
                            (feats[0][:16].contiguous(), 256),
                            (feats[0], 256),
                            (torch.rand(64, 25, device="cuda"), 7))]
    for t in timings:
        print(f"wire_codec {t['shape']} k={t['k']}: kernel {t['ms']:.5f} ms, "
              f"plain {t['plain_ms']:.5f} ms, roundtrip {t['roundtrip_ms']:.5f} "
              f"ms; device {t['device_ms']} ms, plain device "
              f"{t['plain_device_ms']} ms; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")

    phase("4 full-width serving")
    with torch.no_grad():  # warm cuBLAS and the allocator on every route
        for vfl, a, b in ((False, 1, 1), (False, 1, 0), (False, 0, 1), (True, 1, 1)):
            x = np.zeros((2, 64, 128), np.float32)
            predict(models, InferenceRequest(x if a else None, x if b else None,
                                             vfl=vfl),
                    ecfg, spec.kind, server_gmv=gmv, codec="int8_topk",
                    device="cuda")
    torch.cuda.synchronize()
    mixes = ("all_multimodal", "mixed_unimodal", "vfl_heavy")
    engine = ServingEngine(models, ecfg, spec.kind, server_gmv=gmv,
                           cfg=ServingConfig(codec="int8_topk",
                                             capacities=(2, 4, 16, 64)),
                           device="cuda")
    launcher.launches = 0
    rows_by_mix = {}
    for mix in mixes:
        rows_by_mix[mix] = sf.serve_mix(engine, spec, mix, 64, rows=64, seed=0)
    launches = launcher.launches
    vfl_batches = engine.stats["batches_by_route"]["vfl_fallback"]
    for mix, row in rows_by_mix.items():
        print(f"mix {mix:>15}: {row['requests']} req ({row['rows']} rows) "
              f"p50 {row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms "
              f"{row['rps']:.1f} req/s {row['rows_per_s']:.1f} rows/s")
    st = engine.stats
    print(f"engine: {st['batches']} batches {st['batches_by_route']}; "
          f"execute {st['execute_seconds']:.3f} s build {st['build_seconds']:.3f} s "
          f"stall {st['stall_seconds']:.3f} s; wire_codec launches {launches} "
          f"over {vfl_batches} VFL micro-batches")
    check(vfl_batches > 0 and launches == 3 * vfl_batches,
          f"wire_codec launches {launches} != 3 x {vfl_batches} VFL batches")

    analytic = 0
    errs = {"predict": {False: [], True: []}, "cpu": {False: [], True: []}}
    cpu_models = params_from_numpy(params_to_numpy(models), "cpu")
    cpu_gmv = params_from_numpy(params_to_numpy(gmv), "cpu")
    for mix in mixes:
        reqs = sf.make_requests(spec, mix, 64, rows=64, seed=0)
        results = rows_by_mix[mix]["results"]
        check([r.index for r in results] == list(range(len(reqs))),
              f"{mix}: results out of stream order")
        for res, req in zip(results, reqs):
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
            want = predict(models, req, ecfg, spec.kind, server_gmv=gmv,
                           codec=codec, device="cuda")
            errs["predict"][lossy].append((s - want.scores).abs().cpu().numpy())
            # the same models on the CPU, where the codec is the plain version
            on_cpu = predict(cpu_models, req, ecfg, spec.kind,
                             server_gmv=cpu_gmv, codec=codec, device="cpu")
            errs["cpu"][lossy].append((s.cpu() - on_cpu.scores).abs().numpy())
            if lossy:
                analytic += communication_cost(
                    len(req.x_a), ecfg.d_hidden, "vfl", spec.out_dim,
                    codec="int8_topk")["bytes"]
    for against, by_lossy in errs.items():
        for lossy, e in by_lossy.items():
            ok, err, within = sf.within_tolerance(e, lossy)
            label = f"engine vs {against} ({'int8_topk' if lossy else 'local'} routes)"
            print(f"{label}: max abs err {err:.3g}, {within:.5f} of "
                  f"{sum(x.size for x in e)} scores within {sf.ATOL_EXACT}")
            check(ok, f"{label} beyond tolerance")
    check(analytic == st["wire_bytes"],
          f"measured wire bytes {st['wire_bytes']} != analytic {analytic}")
    print(f"scores finite in [0, 1], routes right; wire bytes {analytic} "
          "== analytic")

    # where the time goes: each mix served again under the profiler
    for mix in mixes:
        bd = device_breakdown(
            lambda: sf.serve_mix(engine, spec, mix, 64, rows=64, seed=0),
            rows_by_mix[mix]["wall_s"])
        print(f"{mix}: device busy {bd['busy_ms']:.2f} ms of "
              f"{bd['wall_ms']:.2f} ms wall, idle share {bd['idle_share']:.3f}")
        for k in bd["top"]:
            print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x {k['kernel']}")

    phase("5 CLI selftest")
    launcher.launches = 0
    sf.main(["--selftest", "--codec", "int8_topk", "--device", "cuda"])
    check(launcher.launches > 0, "CLI selftest launched no wire_codec kernel")
    print(f"CLI selftest: {launcher.launches} wire_codec launches")

    main_t = timings[2]
    record = {
        "name": "wire_codec", "route": "cuda",
        "source": "src/repro_torch/kernels/wire_codec/wire_codec.cu",
        "replaces": "src/repro/kernels/wire_codec/wire_codec.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the fused pass
        "shape": main_t["shape"], "per_shape": timings,
    }
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
