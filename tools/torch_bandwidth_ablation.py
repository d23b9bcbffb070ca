#!/usr/bin/env python3
"""Where the time of the port's two bandwidth-bound kernels goes, by
ablation, on one CUDA card: the parameter blend (``blendavg.cu``) and the
wire codec (``wire_codec.cu``).

    python3 tools/torch_bandwidth_ablation.py [--blend-baseline OLD.cu]
        [--codec-baseline OLD.cu]

Builds each source as it is and in variants that change one thing in
its text (one nvcc a variant, all at once), loads each with ctypes and
times it with CUDA events (per call) and the profiler (device time),
inputs rotated over at least 200 MB so that each launch reads HBM.

Blend, at the round's leaf shapes (16, 131,072), (16, 1,048,576),
(17, 2,097,152) and a K = 4 round's (4, 1,048,576), (5, 2,097,152):

- ``kernel``: the source as it is (16-byte loads, 16 loads in flight a
  thread, a grid of the SM count's worth of blocks over the tiles);
- ``no_vec``: the same kernel with every leaf on its scalar path;
- ``one_in_flight``: one row of one unit in flight a thread;
- ``grid_per_tile``: a block a tile, no SM-sized grid;
- ``baseline``: another version's source (``--blend-baseline``, with the
  one-leaf entry ``blend_params_f32(x, omega, out, rows, n, stream)`` of
  the one-launch-a-leaf design), where given.

Codec, at (1, 2,097,152), (16, 1,048,576) and (4, 1,048,576): the pass
given [scale, thresh] and the fused op (selection and pass) of each
``kUnroll`` x ``kCtasPerSm`` of (1, 2, 4, 8) x (4, 8) (the grid of the
digit passes and of the pass), and of the digit passes without their
shared-memory atomics (wrong thresholds: what counting costs); the pass
of the baseline source
(``--codec-baseline``, same entry); the fused op's device time by kernel
name.

Host: microseconds a call of the pieces of a launcher (an allocation,
the stream handle, entering ``torch.cuda.device``) and of each launcher
at a launch-bound shape, beside ``omega @ stacked``.

Prints one JSON line. Needs nvcc and one CUDA card; run from the
repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from array import array
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "bandwidth_ablation"

BLEND_VARIANTS = {
    "kernel": [],
    "one_in_flight": [("  return rows > 8 ? 1 : (rows > 4 ? 2 : 4);", "  return 1;"),
                      ("    case 1: blend_kernel<T, kInFlight, 1>",
                       "    case 1: blend_kernel<T, 1, 1>")],
}
CODEC_VARIANTS = {f"unroll{u}_ctas{c}": [
    ("constexpr int kUnroll = 4;", f"constexpr int kUnroll = {u};"),
    ("constexpr int kCtasPerSm = 8;", f"constexpr int kCtasPerSm = {c};")]
    for u in (1, 2, 4, 8) for c in (4, 8)}
# the fused op's digit passes without their shared-memory histogram
# atomics (wrong thresholds: what the counting costs)
CODEC_VARIANTS["hist_no_atomics"] = [(
    "      atomicAdd(&hist[(key >> shift) & (nb - 1)], 1u);\n  });",
    "      hist[0] += 0u;\n  });")]
BLEND_SHAPES = ((16, 131072), (16, 1048576), (17, 2097152), (4, 1048576),
                (5, 2097152))
CODEC_SHAPES = ((1, 2097152), (16, 1048576), (4, 1048576))


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise ValueError(f"ablation edit no longer matches the source: {old!r}")
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


def host_us(torch, fn, calls=2000) -> float:
    """Microseconds a call on the host clock, the card synchronized once
    at the end (launch-bound work: the card keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--blend-baseline")
    ap.add_argument("--codec-baseline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bandwidth_ablation: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as c
    from repro_torch.kernels import _build, on_device
    from repro_torch.kernels.blendavg import blendavg as blaunch
    from repro_torch.kernels.blendavg import ref as bref
    from repro_torch.kernels.wire_codec import ops, ref
    from repro_torch.kernels.wire_codec import wire_codec as wlaunch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    mem_rate = c.hbm_bytes_per_s(torch.cuda.get_device_name(0))
    jobs = {f"blend_{k}": variant_source((KERNELS / "blendavg" / "blendavg.cu").read_text(), e)
            for k, e in BLEND_VARIANTS.items()}
    jobs |= {f"codec_{k}": variant_source((KERNELS / "wire_codec" / "wire_codec.cu").read_text(), e)
             for k, e in CODEC_VARIANTS.items()}
    if args.blend_baseline:
        jobs["blend_baseline"] = Path(args.blend_baseline).read_text()
    if args.codec_baseline:
        jobs["codec_baseline"] = Path(args.codec_baseline).read_text()
    nvcc = _build.nvcc()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:  # one nvcc a variant, at once
        built = dict(zip(jobs, ex.map(lambda k: build(k, jobs[k], nvcc, _build.NVCC_FLAGS),
                                      jobs)))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch._C._cuda_getCurrentRawStream(0)  # noqa: E731

    # ---- blend
    blend = []
    for l, n in BLEND_SHAPES:
        nxt = c.rotation(lambda: c.blend_inputs(torch, l, n, seed=l + n)
                         + (torch.empty(n, device="cuda"),), l * n * 4)
        x0, om0, _ = nxt()
        want = bref.blend_params_ref(x0, om0)
        row = {"shape": [l, n], "bound_us": (l * n * 4 + n * 4 + l * 4) / mem_rate * 1e6,
               "us": {}, "device_us": {}, "bitwise_equal_to_kernel": {}}
        runs = {}
        for name in ("kernel", "no_vec", "one_in_flight", "grid_per_tile", "baseline"):
            lib_name = {"no_vec": "blend_kernel", "grid_per_tile": "blend_kernel"}.get(
                name, f"blend_{name}")
            if lib_name not in built:
                continue
            lib = ctypes.CDLL(str(built[lib_name][0]))
            if name == "baseline":
                fn = lib.blend_params_f32
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64,
                                                       ctypes.c_void_p]

                def call(args=None, fn=fn):
                    x, om, out = args or nxt()
                    return fn(x.data_ptr(), om.data_ptr(), out.data_ptr(), l, n, stream())
            else:
                fn = lib.blend_tree_f32
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
                per = 1 if name == "one_in_flight" else blaunch.units_for(l)
                vec = name != "no_vec"
                units = n // 4 if vec else n
                tiles = -(-units // (blaunch.THREADS * per))
                grid = tiles if name == "grid_per_tile" else min(tiles, blaunch.CTAS_PER_SM * sms)

                def call(args=None, fn=fn, vec=vec, tiles=tiles, grid=grid):
                    x, om, out = args or nxt()
                    t = array("q", [x.data_ptr(), out.data_ptr(), n, 0, int(vec)])
                    return fn(t.buffer_info()[0], 1, om.data_ptr(), l, tiles, grid, stream())
            out0 = torch.empty(n, device="cuda")
            if call((x0, om0, out0)):
                raise RuntimeError(f"blend {name}: launch failed")
            torch.cuda.synchronize()
            runs[name] = out0
            err = (out0 - want).abs()
            if not bool((err <= bref.blend_error_bound(x0, om0, want, out0)).all()):
                raise AssertionError(f"blend {name} at {(l, n)} beyond its bound")
            row["us"][name] = c.cuda_time_ms(call) * 1e3
            ms = c.device_ms(call, label=f"blend {name}")
            row["device_us"][name] = None if ms is None else ms * 1e3
        for name, out in runs.items():
            row["bitwise_equal_to_kernel"][name] = bool(torch.equal(out, runs["kernel"]))
        row["us"]["omega @ stacked"] = c.cuda_time_ms(lambda: (lambda x, om, _: om @ x)(*nxt())) * 1e3
        ms = c.device_ms(lambda: (lambda x, om, _: om @ x)(*nxt()), label="cublas")
        row["device_us"]["omega @ stacked"] = None if ms is None else ms * 1e3
        blend.append(row)
        print(f"blend {row['shape']}: bound {row['bound_us']:.2f} us; device "
              + ", ".join(f"{k} {v if v is None else round(v, 2)}"
                          for k, v in row["device_us"].items())
              + "; per call " + ", ".join(f"{k} {v:.2f}" for k, v in row["us"].items()),
              flush=True)
        del nxt, runs, x0, om0
        torch.cuda.empty_cache()

    # ---- codec pass, then the fused op by kernel name
    codec = []
    for rows, n in CODEC_SHAPES:
        k = n // 4

        def make():
            x = torch.from_numpy(np.random.default_rng(n).standard_normal(
                (rows, n), np.float32)).cuda()
            return x, ops.scale_thresh(x, k), torch.empty_like(x)

        nxt = c.rotation(make, rows * n * 4)
        x0, st0, _ = nxt()
        want = ref.wire_codec_ref(x0, st0, quantize=True)
        row = {"shape": [rows, n], "bound_us": (rows * n * 8 + rows * 8) / mem_rate * 1e6,
               "device_us": {}, "us": {}, "fused_device_us": {}}
        for name in [k_ for k_ in built if k_.startswith("codec_")]:
            fn = ctypes.CDLL(str(built[name][0])).wire_codec_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                                   ctypes.c_int, ctypes.c_void_p]

            def call(args=None, fn=fn):
                x, st, out = args or nxt()
                return fn(x.data_ptr(), st.data_ptr(), out.data_ptr(), rows, n, 1, stream())

            out0 = torch.empty_like(x0)
            if call((x0, st0, out0)):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out0.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} at {(rows, n)} differs from plain")
            row["us"][name[6:]] = c.cuda_time_ms(call) * 1e3
            ms = c.device_ms(call, label=name)
            row["device_us"][name[6:]] = None if ms is None else ms * 1e3
            if name == "codec_baseline":
                continue
            fused = ctypes.CDLL(str(built[name][0])).wire_codec_fused_f32
            fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
                ctypes.c_int, ctypes.c_void_p]
            ws = torch.empty(rows, wlaunch.WS_WORDS, dtype=torch.int32, device="cuda")
            st = torch.empty(rows, 2, device="cuda")

            def fcall(args=None, fused=fused, ws=ws, st=st):
                x, _, out = args or nxt()
                return fused(x.data_ptr(), out.data_ptr(), st.data_ptr(), ws.data_ptr(),
                             rows, n, k, 1, stream())

            if fcall((x0, st0, out0)):
                raise RuntimeError(f"{name}: fused launch failed")
            torch.cuda.synchronize()
            if name != "codec_hist_no_atomics" and not torch.equal(st, st0):
                raise AssertionError(f"{name} at {(rows, n)}: [scale, thresh] differ")
            ms = c.device_ms(fcall, iters=20, label=f"{name} fused")
            row["fused_device_us"][name[6:]] = None if ms is None else ms * 1e3
        by_name = {}
        for us, calls, kname in c.device_kernels(
                lambda: wlaunch.wire_codec_fused(x0, k=k, quantize=True)):
            key = next((kn for kn in ("narrow_kernel", "hist_kernel", "pass_kernel")
                        if kn in kname), "memset" if "emset" in kname else kname[:50])
            by_name.setdefault(key, []).append(round(us, 3))
        row["fused_device_us_by_kernel"] = by_name
        codec.append(row)
        print(f"codec pass {row['shape']}: bound {row['bound_us']:.2f} us; device "
              + ", ".join(f"{k_} {v if v is None else round(v, 2)}"
                          for k_, v in row["device_us"].items())
              + f"; fused op by kernel {by_name}; fused op by variant "
              + ", ".join(f"{k_} {v if v is None else round(v, 2)}"
                          for k_, v in row["fused_device_us"].items()), flush=True)
        del nxt, x0, st0
        torch.cuda.empty_cache()

    # ---- host cost a call
    dev = torch.device("cuda", 0)
    xs = torch.randn(16, 1024, device="cuda")
    om = torch.full((16,), 1 / 16, device="cuda")
    tree = [torch.randn(16, n, device="cuda") for n in (1024, 1024, 4096, 25, 1000) * 3]
    feats = torch.randn(2, 1024, device="cuda")
    wide = torch.randn(1, 16384, device="cuda")
    outs = [torch.empty(x.shape[1:], device="cuda") for x in tree]
    cols = [o.numel() for o in outs]
    vecs = [blaunch.vector_ok(n, 4, x.data_ptr(), o.data_ptr())
            for n, x, o in zip(cols, tree, outs)]

    def enter_device():
        with torch.cuda.device(dev):
            pass

    def enter_on_device():
        with on_device(dev):
            pass

    def checks():
        for x in tree:
            if x.dtype != torch.float32 or x.dim() < 1 or x.shape[0] != 16 or x.device != dev:
                raise ValueError
            if not x.is_contiguous():
                raise ValueError

    host = {
        "torch.empty": host_us(torch, lambda: torch.empty(1024, device="cuda")),
        "torch.empty(shape[1:], dtype, device)": host_us(
            torch, lambda: torch.empty(xs.shape[1:], dtype=xs.dtype, device=dev)),
        "x.data_ptr()": host_us(torch, lambda: xs.data_ptr()),
        "x.numel()": host_us(torch, lambda: xs.numel()),
        "x.device != dev": host_us(torch, lambda: xs.device != dev),
        "15 leaves: checks": host_us(torch, checks),
        "15 leaves: _layout": host_us(torch, lambda: blaunch._layout(cols, vecs, 4, 16, sms)),
        "current_stream().cuda_stream": host_us(
            torch, lambda: torch.cuda.current_stream(dev).cuda_stream),
        "_cuda_getCurrentRawStream": host_us(
            torch, lambda: torch._C._cuda_getCurrentRawStream(0)),
        "with torch.cuda.device": host_us(torch, enter_device),
        "with on_device (current)": host_us(torch, enter_on_device),
        "blend_params_cuda (16, 1024)": host_us(torch, lambda: blaunch.blend_params_cuda(xs, om)),
        "omega @ stacked (16, 1024)": host_us(torch, lambda: om @ xs),
        "blend_tree_cuda, 15 leaves": host_us(torch, lambda: blaunch.blend_tree_cuda(tree, om)),
        "15 x omega @ stacked": host_us(torch, lambda: [om @ x for x in tree]),
        "wire_codec_fused (2, 1024)": host_us(
            torch, lambda: wlaunch.wire_codec_fused(feats, k=256, quantize=True)),
        "wire_codec_fused (1, 16384)": host_us(
            torch, lambda: wlaunch.wire_codec_fused(wide, k=4096, quantize=True)),
        "torch.empty(rows, 2, dtype, device)": host_us(
            torch, lambda: torch.empty(2, 2, dtype=torch.float32, device=dev)),
        "wire_codec_cuda + scale_thresh (2, 1024)": host_us(
            torch, lambda: wlaunch.wire_codec_cuda(feats, ops.scale_thresh(feats, 256),
                                                   quantize=True)),
    }
    print("host us a call: " + json.dumps({k: round(v, 2) for k, v in host.items()}),
          flush=True)
    print(json.dumps({"device": smi, "blend": blend, "codec": codec, "host_us": host,
                      "ptxas": {name: c.ptxas_summary(log) for name, (_, log) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
