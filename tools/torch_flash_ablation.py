#!/usr/bin/env python3
"""Where the flash attention kernel's time goes, by ablation, on one CUDA
card.

    python3 tools/torch_flash_ablation.py

Builds the port's ``flash_attention.cu`` as it is and in variants that
change one thing in its text, loads each with ctypes and times one
launch with CUDA events (inputs rotated over four sets, so that each
launch reads HBM) beside ``scaled_dot_product_attention`` on the same
inputs, at the transformer encoder's shape (64, 4, 64, 256, non-causal)
and a long causal GQA case (1, 8, 2, 1024, 1024, 128), in f32 and bf16.
Variants:

- ``kernel``: the source as it is;
- ``cvt_split``: the TF32 split through the ``cvt.rna.tf32.f32``
  instruction instead of its two integer operations (the same values);
- ``one_pass``: f32 products in plain TF32 (big * big only), which misses
  the f32 tolerance: what the 3xTF32 split costs;
- ``no_products``: neither product runs (staging, softmax bookkeeping and
  stores only; the output is wrong): what the memory pipeline costs.

Prints one JSON line: per case and dtype, microseconds a launch of each
variant and of SDPA, each variant's max abs error against the plain
version, and ptxas's registers and spills of each variant. Needs nvcc
and one CUDA card; run from the repository root.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_ablation"

CVT_SPLIT = '''__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;
}'''
VARIANTS = {
    "kernel": [],
    "cvt_split": [(None, CVT_SPLIT)],
    "one_pass": [("  mma_tf32(c, a_small, b_big[0], b_big[1]);\n"
                  "  mma_tf32(c, a_big, b_small[0], b_small[1]);\n", "")],
    "no_products": [("    tile_scores<KD, NK>(", "    if (0) tile_scores<KD, NK>("),
                    ("    tile_pv<KD, NK>(", "    if (0) tile_pv<KD, NK>(")],
}
CASES = ((64, 4, 4, 64, 64, 256, False), (1, 8, 2, 1024, 1024, 128, True))


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old is None:  # replace the rna_tf32 function
            start = src.index("__device__ __forceinline__ uint32_t rna_tf32")
            end = src.index("}", start) + 1
            src = src[:start] + new + src[end:]
            continue
        if old not in src:
            raise ValueError(f"ablation edit no longer matches the source: {old!r}")
        src = src.replace(old, new)
    return src


def build(name: str, nvcc: str, flags) -> tuple:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(variant_source(SOURCE.read_text(), VARIANTS[name]))
    lib = OUT / f"{name}.so"
    res = subprocess.run([nvcc, *flags, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return lib, res.stdout + res.stderr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ablation: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ref as fref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = _build.nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:  # one nvcc a variant, at once
        built = dict(zip(VARIANTS, ex.map(
            lambda n: build(n, nvcc, _build.NVCC_FLAGS), VARIANTS)))
    F = torch.nn.functional
    results = []
    for b, hq, hkv, sq, sk, d, causal in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            ins = [[torch.randn(*shape, device="cuda", dtype=dtype)
                    for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
                   for _ in range(4)]
            want = fref.flash_attention_ref(*ins[0], causal=causal).float()
            out = torch.empty_like(ins[0][0])
            row = {"shape": [b, hq, hkv, sq, sk, d], "causal": causal,
                   "dtype": str(dtype)[6:], "us": {}, "max_abs_err": {}}
            turn = {"i": 0}

            def nxt():
                turn["i"] = (turn["i"] + 1) % len(ins)
                return ins[turn["i"]]

            for name, (lib, _) in built.items():
                fn = getattr(ctypes.CDLL(str(lib)), "flash_attention_f32"
                             if dtype == torch.float32 else "flash_attention_bf16")
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_void_p])

                def call(x=None):
                    q, k, v = x or nxt()
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             None, b, hq, hkv, sq, sk, d, int(causal), 0, 0.0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call(ins[0])
                torch.cuda.synchronize()
                row["max_abs_err"][name] = float((out.float() - want).abs().max())
                row["us"][name] = chip_smoke.cuda_time_ms(call) * 1e3
            row["us"]["sdpa"] = chip_smoke.cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    *nxt(), is_causal=causal, enable_gqa=hq != hkv)) * 1e3
            results.append(row)
            print(f"{row['shape']} causal={causal} {row['dtype']}: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in row["us"].items()), flush=True)
    print(json.dumps({"device": smi, "cases": results, "ptxas": {
        name: chip_smoke.ptxas_summary(log) for name, (_, log) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
