#!/usr/bin/env python3
"""The sLSTM cell and flash attention forwards against older sources of
the same kernels, bit for bit, on one CUDA card.

    python3 tools/torch_forward_baseline.py --slstm OLD/slstm_cell.cu \
        --flash OLD/flash_attention.cu

Builds each older source (``git show <commit>:src/repro_torch/kernels/
...`` into the gitignored ``build/``), calls its ``slstm_cell_f32`` /
``_bf16`` (or, where it has them, ``slstm_cell_stacked_*`` with one client)
and ``flash_attention_f32`` / ``_bf16`` entry points (with a null
log-sum-exp pointer and a logit cap of 0 where they take them), and holds
their outputs against the port's launchers as they are: the plain call,
the saving forward (``save=True``), the stacked form at C = 1 (a 4-d r)
and the forward that also writes the log-sum-exp (``return_lse=True``),
at the encoders' serving shapes and a few edges. Prints one JSON line of
cases, each with ``equal`` true or false, and exits 1 if any differs.
Needs nvcc and one CUDA card; run from the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "forward_baseline"

SLSTM_CASES = [  # b, h, s, hd, dtype
    (64, 4, 64, 256, "float32"), (2, 4, 64, 256, "float32"),
    (17, 4, 50, 256, "float32"), (5, 3, 9, 255, "float32"),
    (1, 2, 32, 16, "float32"), (64, 4, 64, 256, "bfloat16"),
]
FLASH_CASES = [  # b, hq, hkv, sq, sk, d, causal, dtype
    (64, 4, 4, 64, 64, 256, False, "float32"),
    (2, 8, 2, 128, 128, 64, True, "float32"),
    (1, 4, 4, 40, 72, 16, True, "float32"),
    (64, 4, 4, 64, 64, 256, False, "bfloat16"),
]


def build(name: str, src: Path, nvcc: str, flags) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{name}.so"
    subprocess.run([nvcc, *flags, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slstm", type=Path, required=True)
    ap.add_argument("--flash", type=Path, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_forward_baseline: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as flaunch
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch

    nvcc = _build.nvcc()
    old_s = ctypes.CDLL(str(build("slstm_old", args.slstm, nvcc, _build.NVCC_FLAGS)))
    old_f = ctypes.CDLL(str(build("flash_old", args.flash, nvcc, _build.NVCC_FLAGS)))
    # whether the older flash entry points take the log-sum-exp pointer
    flash_lse = re.search(r"flash_attention_f32\([^)]*float\* lse",
                          args.flash.read_text()) is not None
    # and whether they take the logit cap (0: none) before the stream
    flash_cap = re.search(r"flash_attention_f32\([^)]*float softcap",
                          args.flash.read_text()) is not None
    stream = torch.cuda.current_stream().cuda_stream
    cases, ok = [], True
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, s, hd, dname in SLSTM_CASES:
        dtype = getattr(torch, dname)
        pre = (torch.randn((b, h, s, 4, hd), device="cuda", generator=gen) * 0.5).to(dtype)
        r = (torch.randn((h, hd, 4 * hd), device="cuda", generator=gen)
             / hd ** 0.5).to(dtype)
        tag = "f32" if dname == "float32" else "bf16"
        old = torch.empty((b, h, s, hd), dtype=dtype, device="cuda")
        if hasattr(old_s, f"slstm_cell_stacked_{tag}"):
            fn = getattr(old_s, f"slstm_cell_stacked_{tag}")
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            head, dims = [None] * 9, (1, b, h, s, hd)
        else:
            fn = getattr(old_s, f"slstm_cell_{tag}")
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            head, dims = [None] * 8, (b, h, s, hd)
        fn.restype = ctypes.c_int
        if fn(pre.data_ptr(), r.data_ptr(), old.data_ptr(), *head, *dims, stream):
            raise RuntimeError("old slstm_cell launch failed")
        forms = {"plain": slaunch.slstm_cell_cuda(pre, r),
                 "stacked_c1": slaunch.slstm_cell_cuda(pre, r[None].contiguous())}
        if dname == "float32":
            forms["saving"] = slaunch.slstm_cell_cuda(pre, r, save=True)[0]
        torch.cuda.synchronize()
        for form, new in forms.items():
            eq = bool(torch.equal(old, new))
            ok &= eq
            cases.append({"kernel": "slstm_cell", "shape": [b, h, s, hd],
                          "dtype": dname, "form": form, "equal": eq})
    for b, hq, hkv, sq, sk, d, causal, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn((b, hq, sq, d), device="cuda", generator=gen).to(dtype)
        k = torch.randn((b, hkv, sk, d), device="cuda", generator=gen).to(dtype)
        v = torch.randn((b, hkv, sk, d), device="cuda", generator=gen).to(dtype)
        fn = getattr(old_f, "flash_attention_f32" if dname == "float32"
                     else "flash_attention_bf16")
        lse_ptr = [None] if flash_lse else []
        cap = [0.0] if flash_cap else []
        fn.argtypes = ([ctypes.c_void_p] * (4 + len(lse_ptr)) + [ctypes.c_int] * 8
                       + [ctypes.c_float] * len(cap) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        old = torch.empty_like(q)
        if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), old.data_ptr(), *lse_ptr,
              b, hq, hkv, sq, sk, d, int(causal), 0, *cap, stream):
            raise RuntimeError("old flash_attention launch failed")
        forms = {"plain": flaunch.flash_attention_cuda(q, k, v, causal=causal,
                                                       window=0)}
        if dname == "float32":
            forms["with_lse"] = flaunch.flash_attention_cuda(
                q, k, v, causal=causal, window=0, return_lse=True)[0]
        torch.cuda.synchronize()
        for form, new in forms.items():
            eq = bool(torch.equal(old, new))
            ok &= eq
            cases.append({"kernel": "flash_attention",
                          "shape": [b, hq, hkv, sq, sk, d], "causal": causal,
                          "dtype": dname, "form": form, "equal": eq})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "all_equal": ok,
                      "cases": cases}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
