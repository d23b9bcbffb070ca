#!/usr/bin/env python3
"""Where the sLSTM kernel's time goes, by ablation, on one CUDA card.

    python3 tools/torch_slstm_ablation.py [--baseline OTHER/slstm_cell.cu]

Builds the port's ``slstm_cell.cu`` as it is and in variants that change
one thing in its text, loads each with ctypes and times one launch with
CUDA events (inputs rotated over four sets, so that each launch reads
its pre-activations from HBM) at the recurrent encoder's shapes (2 and
64 rows, 4 heads, S = 64, hd = 256, from the zero state) and
xlstm-350m's (8 rows, S = 512 and a decode step S = 1, from a running
state), in f32, and (64, 4, 64, 256) in bf16. Variants:

- ``kernel``: the source as it is;
- ``no_exchange``: neither the h stores to the cluster's CTAs nor the
  waits for them: a step is products and gate math;
- ``no_products``: the recurrent products do not run (acc = 0);
- ``no_gate_math``: h_t = the four gates' pre + acc summed, in place of
  the gates and the state update.

- ``four_gates``: all four gates a thread at one row a cluster too;
- ``over_budget``: one cluster more than the card holds at once in the
  plan's budget (a second wave where a call uses the whole budget).

``no_exchange``, ``no_products`` and ``no_gate_math`` give wrong outputs:
they are timed only.
Each is called through its ``slstm_cell_stacked_<dtype>`` entry with one
client and nothing saved. ``--baseline`` builds another version of the
kernel's source (one older than the stacked entry through its
``slstm_cell_<dtype>`` entry), times it beside the rest and reports whether its f32
outputs and final state are bitwise equal to the kernel's on the same
inputs.

Prints one JSON line: per case, microseconds a launch of each variant
(CUDA events; at S = 1 they time the host's launch loop) and the
profiler's device microseconds of the kernel and the baseline, the
kernel's max abs error against the plain version, which variants' outputs
equal the kernel's, the bitwise comparison, and ptxas's registers and
spills of each variant. Needs
nvcc and one CUDA card; run from the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "slstm_cell" / "slstm_cell.cu"
OUT = ROOT / "build" / "slstm_ablation"

# no h stores to the cluster's CTAs, no waits for them and no re-arming
# of their barriers (no CTA ever stores into another: nothing to wait for
# before leaving)
EXCHANGE = [("    if (unit_ok)\n      exchange_h<RT>(", "    if (false)\n      exchange_h<RT>("),
            ("      wait_h(bar0, t);\n      if (tid == 0 && t + 2 <= seq)\n"
             "        bar_arm(bar0 + 8 * (t & 1), h_bytes);  // step t + 2's h\n", ""),
            ("  if (seq > 0) wait_h(bar0, seq);\n", "")]
VARIANTS = {
    "kernel": [],
    "no_exchange": EXCHANGE,
    "no_products": [("    if (unit_ok)\n      products<RT, GT>(", "    if (false)\n      products<RT, GT>(")],
    "no_gate_math": [("      hn[k] = cell_update(x, c[k], n[k], m[k]);",
                      "      hn[k] = x[0] + x[1] + x[2] + x[3];")],
    # design choices, outputs right: all four gates a thread at one row
    # a cluster too (one warp a CTA there); one cluster more than the
    # card holds at once (a second wave at 64 and 8 rows)
    "four_gates": [("  p.gates_per_thread = rows == 1 ? 1 : 4;",
                    "  p.gates_per_thread = 4;")],
    "over_budget": [("  cache[key] = *budget;", "  *budget += 1;\n  cache[key] = *budget;")],
}
# (b, h, s, hd, from a running state, dtype name)
CASES = ((2, 4, 64, 256, False, "float32"), (64, 4, 64, 256, False, "float32"),
         (8, 4, 512, 256, True, "float32"), (8, 4, 1, 256, True, "float32"),
         (64, 4, 64, 256, False, "bfloat16"))


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise ValueError(f"ablation edit no longer matches the source: {old!r}")
        src = src.replace(old, new)
    return src


def entry(lib, tag: str):
    """The library's launch for dtype ``tag`` (f32 or bf16) as fn(pre_x,
    r, out, c0..h0, c1..h1, batch, heads, seq, hd, stream): its stacked
    entry with one client and no save pointer, or the plain entry of a
    source older than it."""
    tail = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    if not hasattr(lib, f"slstm_cell_stacked_{tag}"):
        fn = getattr(lib, f"slstm_cell_{tag}")
        fn.argtypes = [ctypes.c_void_p] * 11 + tail
        fn.restype = ctypes.c_int
        return fn
    fn = getattr(lib, f"slstm_cell_stacked_{tag}")
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def stacked(pre, r, out, *args):
        *ptrs, b, h, s, hd, stream = args
        return fn(pre, r, out, None, *ptrs, 1, b, h, s, hd, stream)

    return stacked


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another slstm_cell.cu to time and compare bit for bit")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_slstm_ablation: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm_cell import ref as sref
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = _build.nvcc()
    texts = {name: variant_source(SOURCE.read_text(), edits)
             for name, edits in VARIANTS.items()}
    if args.baseline is not None:
        texts["baseline"] = args.baseline.read_text()
    with ThreadPoolExecutor(len(texts)) as ex:  # one nvcc a variant, at once
        built = dict(zip(texts, ex.map(
            lambda n: build(n, texts[n], nvcc, _build.NVCC_FLAGS), texts)))
    results = []
    for b, h, s, hd, stateful, dname in CASES:
        dtype = getattr(torch, dname)
        ins = []
        for i in range(4):
            pre, r = chip_smoke.slstm_inputs(torch, b, h, s, hd, seed=i, dtype=dtype)
            st = (chip_smoke.running_state(torch, b, h, hd, seed=i)
                  if stateful else None)
            ins.append((pre, r, st))
        out = torch.empty((b, h, s, hd), dtype=dtype, device="cuda")
        fin = [torch.empty((b, h, hd), device="cuda") for _ in range(4)]
        want = sref.slstm_cell_ref(*ins[0][:2], ins[0][2])
        plan = slaunch.kernel_plan(b, h, hd, dtype)[0]
        row = {"shape": [b, h, s, hd], "state": stateful, "dtype": dname,
               "plan": vars(plan), "us": {}}
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % len(ins)
            return ins[turn["i"]]

        outputs = {}
        for name, (lib, _) in built.items():
            fn = entry(ctypes.CDLL(str(lib)),
                       "f32" if dtype == torch.float32 else "bf16")

            def call(x=None, fn=fn, name=name):
                pre, r, st = x or nxt()
                ptrs = [None if st is None else t.data_ptr() for t in (st or (None,) * 4)]
                err = fn(pre.data_ptr(), r.data_ptr(), out.data_ptr(), *ptrs,
                         *(t.data_ptr() for t in fin), b, h, s, hd,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call(ins[0])
            torch.cuda.synchronize()
            outputs[name] = (out.clone(), [t.clone() for t in fin])
            row["us"][name] = chip_smoke.cuda_time_ms(
                call, iters=20 if s >= 512 else 100, warmup=3) * 1e3
            if name in ("kernel", "baseline"):  # the device's own time
                ms = chip_smoke.device_ms(call, iters=10, label=f"{name} {b, h, s, hd}")
                row.setdefault("device_us", {})[name] = None if ms is None else ms * 1e3
        got = outputs["kernel"][0]
        row["same_as_kernel"] = {name: bool(torch.equal(o[0], got))
                                 for name, o in outputs.items()}
        row["max_abs_err"] = float((got.float() - want.float()).abs().max())
        row["within_bound"] = bool(((got.float() - want.float()).abs()
                                    <= sref.slstm_error_bound(want, got)).all())
        if "baseline" in outputs:
            base, base_fin = outputs["baseline"]
            row["bitwise_equal_to_baseline"] = bool(
                torch.equal(got, base) and (not stateful or all(
                    torch.equal(x, y) for x, y in zip(outputs["kernel"][1], base_fin))))
            row["max_abs_diff_to_baseline"] = float((got.float() - base.float()).abs().max())
        results.append(row)
        print(f"{row['shape']} state={stateful} {dname}: " + ", ".join(
            f"{k} {v:.2f} us" for k, v in row["us"].items())
            + f"; device {row['device_us']}"
            + f"; max abs err {row['max_abs_err']:.3g}"
            + (f"; bitwise equal to baseline: {row['bitwise_equal_to_baseline']}"
               if "baseline" in outputs else ""), flush=True)
        del ins, out, fin, want, outputs
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "cases": results, "ptxas": {
        name: chip_smoke.ptxas_summary(log) for name, (_, log) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
