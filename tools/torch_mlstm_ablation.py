#!/usr/bin/env python3
"""Where the mLSTM scan kernel's time goes, by ablation, on one CUDA card.

    python3 tools/torch_mlstm_ablation.py [--baseline OTHER/mlstm_scan.cu] [--baseline ...]

Builds the port's ``mlstm_scan.cu`` as it is and in variants that change
one thing in its text, loads each with ctypes and times one launch with
CUDA events (inputs rotated over at least 200 MB, so that each launch
reads q, k and v from HBM) at xlstm-350m's prefill shape (8, 4, 512,
512, 512) and at the card-against-CPU shape (2, 4, 128, 512, 512), chunk
64, normalize on, with the final (C, n). Variants:

- ``kernel``: the source as it is, with the plan's cluster size;
- ``no_scores``: the score products do not run (P is the decay of zero);
- ``no_inter``: the q.C products do not run;
- ``no_state``: the state products do not run (C only decays);
- ``sync_staging``: each q, k tile's copy is waited for as soon as it is
  issued, so no copy overlaps a product;
- ``cluster_<c>``: the kernel with its plan's choice of cluster size
  replaced by c, for each c the plan may take at that shape (1, 2, 4, 8
  up to the column blocks, where they fit).

``no_scores``, ``no_inter`` and ``no_state`` give wrong outputs: they are
timed only; so are the probes ``no_products`` (no product at all: what
is left is staging, barriers and the chunk's tail) and ``tk16`` (dk tiles
of 16 and two k stages). ``--baseline`` (repeatable) builds another
version of the kernel's source (the same ``mlstm_scan_f32`` entry point)
and times it beside the rest, as ``baseline``, ``baseline_2``, ...

It also times the card's mma.sync.m16n8k8 TF32 on its own (``MMA_RATE``):
cycles a scheduler spends on one MMA with one dependent chain (its
latency) and with eight independent chains in each of two warps (its
throughput), and the same for FFMA.

Prints a line a case and one JSON line: per case, microseconds a launch
of each variant (CUDA events; the median of ROUNDS rounds, in each of
which every variant is timed once, the order reversed each round so
that none always runs first), the profiler's device microseconds of the
kernel and the baselines, the plan, the kernel's max abs error against
the plain version and whether it is within ``mlstm_error_bound``, and
ptxas's registers and spills of each variant. Needs nvcc and one CUDA
card; run from the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "mlstm_scan" / "mlstm_scan.cu"
OUT = ROOT / "build" / "mlstm_ablation"

VARIANTS = {
    "kernel": [],
    "no_scores": [("        mma16_all<NQ + NS>(blk, a, b);", "        mma16_all<NQ>(blk, a, b);")],
    "no_inter": [("        mma16_all<NQ + NS>(blk, a, b);",
                  "        mma16_all<NS>(blk + NQ, a, b + NQ);")],
    "no_state": [(f"            mma_tf32(acc[hh][i], {x}, {y}[hh][i][0], {y}[hh][i][1]);\n",
                  "            ;\n")
                 for x, y in (("as[hh]", "bb"), ("ab[hh]", "bs"), ("ab[hh]", "bb"))],
    "sync_staging": [("    cp_async_commit();\n  };\n  auto issue_v",
                      "    cp_async_commit();\n    cp_async_wait_all();\n  };\n"
                      "  auto issue_v")],
}
# probes, timed only
VARIANTS["no_products"] = ([("        mma16_all<NQ + NS>(blk, a, b);\n", "")]
                           + VARIANTS["no_state"]
                           + [("      mma16_all<NQ>(blk, a, b);\n", "")])
VARIANTS["tk16"] = [("  if (smem_bytes_tk(L, dk, 32, cluster) <= kMaxSmem) return 32;\n", "")]

# (b, h, s, dk, dv, chunk)
ROUNDS = 8  # each variant timed once a round
CASES = ((8, 4, 512, 512, 512, 64), (2, 4, 128, 512, 512, 64))

# one block a SM; each warp runs `chains` independent accumulators
MMA_RATE = r"""
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[0] ^ k), "r"(a[1] + i));
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CHAINS>
__global__ void ffma_loop(float* out, int iters) {
  float c[CHAINS];
  const float x = threadIdx.x * 1e-3f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) c[k] = k;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) c[k] = fmaf(c[k], 1.0001f, x);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" void mma_1(float* o, int n, int b, int t) { mma_loop<1><<<b, t>>>(o, n); }
extern "C" void mma_8(float* o, int n, int b, int t) { mma_loop<8><<<b, t>>>(o, n); }
extern "C" void ffma_8(float* o, int n, int b, int t) { ffma_loop<8><<<b, t>>>(o, n); }
"""


def mma_rate(torch, lib: Path) -> dict:
    """Cycles a scheduler spends on one warp-wide MMA (or FFMA): one chain
    in one warp a scheduler (latency), eight chains in each of two warps
    (throughput); at the SM clock nvidia-smi reports."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    so = ctypes.CDLL(str(lib))
    out = torch.empty(sms * 256, device="cuda")
    res = {"sm_clock_mhz": mhz}
    for name, chains, threads in (("mma_1", 1, 128), ("mma_8", 8, 256), ("ffma_8", 8, 256)):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        iters = 20000
        fn(out.data_ptr(), 10, sms, threads)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(out.data_ptr(), iters, sms, threads)
        end.record()
        torch.cuda.synchronize()
        per_scheduler = threads // 32 // 4 * chains * iters  # warp instructions
        res[f"{name}_{threads // 128}w"] = (start.elapsed_time(end) * 1e-3 * mhz * 1e6
                                           / per_scheduler)
    return res


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"ablation edit no longer matches the source once: {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str, text: str, nvcc: str, flags) -> tuple:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    res = subprocess.run([nvcc, *flags, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


# the plan takes cluster C wherever it may (its wave check replaced)
PICK = "    if (x.waves <= waves1) best = x;"


def cluster_edits(c: int) -> list:
    return [(PICK, f"    if (kClusters[i] == {c}) best = x;" if c > 1 else "")]


def entry(lib: Path):
    fn = ctypes.CDLL(str(lib)).mlstm_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another mlstm_scan.cu to time beside the variants "
                         "(repeatable)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_mlstm_ablation: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mlaunch
    from repro_torch.kernels.mlstm_scan import ref as mref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = _build.nvcc()
    variants = dict(VARIANTS)
    variants.update({f"cluster_{c}": cluster_edits(c) for c in mlaunch.CLUSTERS})
    texts = {name: variant_source(SOURCE.read_text(), edits)
             for name, edits in variants.items()}
    baselines = {"baseline" + (f"_{i + 1}" if i else ""): str(path)
                 for i, path in enumerate(args.baseline)}
    for name, path in baselines.items():
        texts[name] = Path(path).read_text()
    texts["mma_rate"] = MMA_RATE
    with ThreadPoolExecutor(len(texts)) as ex:  # one nvcc a variant, at once
        built = dict(zip(texts, ex.map(
            lambda n: build(n, texts[n], nvcc, _build.NVCC_FLAGS), texts)))
    rate = mma_rate(torch, built.pop("mma_rate")[0])
    print(f"cycles a scheduler spends on a warp's instruction: {rate}", flush=True)
    results = []
    for b, h, s, dk, dv, chunk in CASES:
        nbytes = 4 * b * h * (s * (2 * dk + 2 * dv + 1) + dk * dv + dk)
        nxt = chip_smoke.rotation(
            lambda: chip_smoke.mlstm_inputs(torch, b, h, s, dk, dv, seed=1), nbytes)
        first = nxt()
        out = torch.empty((b, h, s, dv), device="cuda")
        c_out = torch.empty((b, h, dk, dv), device="cuda")
        n_out = torch.empty((b, h, dk), device="cuda")
        want, _ = mref.mlstm_scan_ref(*first, return_state=True)
        plan, active = mlaunch.kernel_plan(b * h, dk, dv, chunk)
        row = {"shape": [b, h, s, dk, dv], "chunk": chunk, "plan": vars(plan),
               "active": active, "us": {}}
        runs = []
        for name, (lib, _) in built.items():
            if name.startswith("cluster_"):
                try:  # a size this shape can take?
                    mlaunch.plan(b * h, dk, dv, chunk, active, cluster=int(name[8:]))
                except ValueError:
                    continue
            runs.append((name, entry(lib)))
        outputs, calls = {}, {}
        for name, fn in runs:
            def call(x=None, fn=fn, name=name):
                q, k, v, lf = x or nxt()
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                         out.data_ptr(), c_out.data_ptr(), n_out.data_ptr(),
                         b * h, s, dk, dv, chunk, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call(first)
            torch.cuda.synchronize()
            outputs[name] = out.clone()
            calls[name] = call
        # every variant timed once a round, in turns: the order reverses
        # each round, so that no variant always runs first; the median
        rounds = {name: [] for name in calls}
        for r in range(ROUNDS):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                rounds[name].append(
                    chip_smoke.cuda_time_ms(calls[name], iters=20, warmup=3) * 1e3)
        row["us"] = {name: statistics.median(ts) for name, ts in rounds.items()}
        row["us_rounds"] = rounds
        for name in ["kernel", *baselines]:  # the device's own time
            ms = chip_smoke.device_ms(calls[name], iters=10, label=f"{name} {row['shape']}")
            row.setdefault("device_us", {})[name] = None if ms is None else ms * 1e3
        got = outputs["kernel"]
        err = (got - want).abs()
        row["max_abs_err"] = float(err.max())
        row["within_bound"] = bool((err <= mref.mlstm_error_bound(want)).all())
        row["forced_within_bound"] = {
            name: bool(((o - want).abs() <= mref.mlstm_error_bound(want)).all())
            for name, o in outputs.items() if name.startswith("cluster_")}
        for name in baselines:
            row[f"{name}_within_bound"] = bool(
                ((outputs[name] - want).abs() <= mref.mlstm_error_bound(want)).all())
            row[f"bitwise_equal_to_{name}"] = bool(torch.equal(got, outputs[name]))
        results.append(row)
        print(f"{row['shape']} chunk {chunk}, plan cluster {plan.cluster} "
              f"({plan.clusters} clusters, {plan.waves} waves, {plan.smem} B): "
              + ", ".join(f"{k} {v:.2f} us" for k, v in row["us"].items())
              + f"; device {row['device_us']}; max abs err {row['max_abs_err']:.3g}"
              + "".join(f"; bitwise equal to {name}: {row[f'bitwise_equal_to_{name}']}"
                        for name in baselines),
              flush=True)
        del nxt, first, out, c_out, n_out, want, outputs, got
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "baselines": baselines,
                      "cycles_per_instruction": rate,
                      "cases": results, "ptxas": {
        name: chip_smoke.ptxas_summary(log) for name, (_, log) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
