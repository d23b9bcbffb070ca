#!/usr/bin/env python3
"""The training backward kernels beside other versions of their sources,
and where their time goes by ablation, on one CUDA card.

    python3 tools/torch_bwd_ablation.py [--slstm-baseline OTHER/slstm_cell_bwd.cu]
                                        [--flash-baseline OTHER/flash_attention_bwd.cu]
                                        [--mlstm-baseline OTHER/mlstm_scan_bwd.cu]

Builds the port's ``slstm_cell_bwd.cu``, ``flash_attention_bwd.cu`` and
``mlstm_scan_bwd.cu`` as they are and in variants that change one thing
in their text, plus each baseline given, loads each with ctypes and calls
its C entry point (``slstm_cell_bwd_f32``, ``flash_attention_bwd_f32``,
``mlstm_scan_bwd_f32``: the same in every version) at the training
shapes: for the encoders a round's stacked (16 clients x 64 rows, 4
heads, S = 64, hd = d = 256) and one client's (64 rows); for the mLSTM
scan xlstm-350m's (8, 4, 128, 512, 512) with the normalizer and
hymba-1.5b's Mamba heads (2, 25, 2048, 16, 64) without (the scratch
passed as ``du`` is the current source's, which holds the older one's du).
The versions are timed in turns (kernel, baseline, variants, then the
kernel and the baseline again), each a call with CUDA events over inputs
rotated across at least 200 MB, so that each call reads HBM; r_h^T and
the outputs are made once, outside the timed calls. Variants (timed
and, where their outputs are meant to be right (``RIGHT``), held to the
plain backward like the kernel:

- sLSTM ``no_exchange``: no partial sums are sent and none is waited for
  (a step is the adjoint and the product); ``no_products``: the product
  loop does not run (zeros are sent); ``no_adjoint``: each gate gradient
  is dh, in place of the adjoint's arithmetic; ``scalar_sends`` (right):
  the partial sums sent 4 bytes a ``st.async`` where the kernel sends 8
  (the path of an odd number of units a CTA); ``one_pass``: one TF32
  product in place of the 3xTF32 split's three; ``rn_accum`` (right):
  each 3xTF32 step into a zeroed fragment, added to the running sum in
  f32 with round-to-nearest (``mma_3xtf32_rn``);
- flash ``one_pass``: the same; ``no_phase2``: dv, dk and dq's products
  do not run; ``no_products``: no product runs (staging, softmax and
  stores only); ``tc_accum`` (right): phase 1's sums (s, dp) added in
  the tensor cores, as phase 2's are; ``rn_accum`` (right): phase 2's
  too with round-to-nearest; ``four_pass`` (right): the split's fourth
  product, small * small, too;
- mLSTM ``one_pass``: one TF32 product (big * big) in place of the
  split's three; ``no_products``: no MMA runs (staging, the states' pass,
  the normalize step, the stores only); ``ring3``, ``ring4`` (right): a
  ring of 3 or 4 stages for the slice pipelines (2 in the source: 1
  slice in flight); ``state_lb2`` (right): the state kernel at 128
  registers, two CTAs an SM (three, at 85, in the source); ``pass_b8``
  (right): the states' pass with 8 updates' loads in flight (4 in the
  source); ``scores_per_block`` (right): the
  scores launch repeated once a column tile, the work of recomputing each
  chunk's scores for every column block as the SIMT design did.

The kernels' shared headers (``kernels/*.cuh``) are inlined into each
copy before it is edited and built.

Prints one JSON line: per kernel and shape, microseconds a call of each
version (both turns of the kernel and the baseline), the profiler's
device microseconds of the kernel and the baseline
(``chip_smoke.counted_ms``), the max abs error of each output of every
right version against the plain backward (for flash also against the
plain backward in f64, the plain one's own error beside them), and
ptxas's registers and spills of every build. Needs nvcc and one CUDA card; run from the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = {"slstm": KERNELS / "slstm_cell" / "slstm_cell_bwd.cu",
           "flash": KERNELS / "flash_attention" / "flash_attention_bwd.cu",
           "mlstm": KERNELS / "mlstm_scan" / "mlstm_scan_bwd.cu"}
OUT = ROOT / "build" / "bwd_ablation"

# the flash kernel's phase 1 (s, dp; its sums added with round-to-nearest,
# mma_3xtf32_rn) and phase 2 (dv, dk, dq; its sums in the tensor cores)
FLASH_PHASE1_TC = [("mma_3xtf32_rn(s[nt],", "mma_3xtf32(s[nt],"),
                   ("mma_3xtf32_rn(dp[nt],", "mma_3xtf32(dp[nt],")]
FLASH_PHASE2_RN = [(f"mma_3xtf32(acc[{m}][nt],", f"mma_3xtf32_rn(acc[{m}][nt],")
                   for m in range(3)]

VARIANTS = {
    "slstm": {
        # no sends, no waits for them and no re-arming of their barriers
        # (no CTA stores into another: nothing to wait for before leaving)
        "no_exchange": [
            ("      wait_msg(bar0, u - 1);\n      if (tid == 0 && u + 1 <= seq - 2)\n"
             "        bar_arm(bar0 + 8 * ((u - 1) & 1), msg_bytes);  // message u + 1\n", ""),
            ("            st_async2(dst[j] + off + row * units * (int)sizeof(float), a, b,\n"
             "                      dst_bar[j] + 8 * (u & 1));",
             "            if (a == 1234.5f) recv[0] = b;"),
            ("              st_async(map_rank(smem_addr(recv + (u & 1) * buf + rank * slot +\n"
             "                                          row * units + (i - owner * units)),\n"
             "                                owner),\n"
             "                       e == 0 ? a : b, map_rank(bar0 + 8 * (u & 1), owner));",
             "              if (a == 1234.5f + i) recv[0] = b;")],
        "scalar_sends": [("  const bool pairs_of_cols = units % 2 == 0;",
                          "  const bool pairs_of_cols = false;")],
        "no_products": [("    for (int k0 = 0; k0 < pl.kpad; k0 += 8) {",
                         "    for (int k0 = 0; k0 < 0; k0 += 8) {")],
        "no_adjoint": [("      adjoint(cur[q], dh, dc[q], dn[q], dm[q], g4[q]);",
                        "      g4[q][0] = g4[q][1] = g4[q][2] = g4[q][3] = dh;")],
        "one_pass": [("  mma_tf32(c, a_small, b_big[0], b_big[1]);\n"
                      "  mma_tf32(c, a_big, b_small[0], b_small[1]);\n", "")],
        "rn_accum": [("mma_3xtf32(acc[m][j],", "mma_3xtf32_rn(acc[m][j],")],
    },
    "flash": {
        "one_pass": [("  mma_tf32(c, a_small, b_big[0], b_big[1]);\n"
                      "  mma_tf32(c, a_big, b_small[0], b_small[1]);\n", "")],
        "no_phase2": [("    for (int kb = 0; kb < kTile; kb += 8) {",
                       "    for (int kb = 0; kb < 0; kb += 8) {")],
        "no_products": [("    for (int kb = 0; kb < kTile; kb += 8) {",
                         "    for (int kb = 0; kb < 0; kb += 8) {"),
                        ("    for (int kk = 0; kk < kChA; kk += 8) {",
                         "    for (int kk = 0; kk < 0; kk += 8) {")],
        "tc_accum": FLASH_PHASE1_TC,
        "rn_accum": FLASH_PHASE2_RN,
        "four_pass": [("  mma_tf32(c, a_small, b_big[0], b_big[1]);\n",
                       "  mma_tf32(c, a_small, b_small[0], b_small[1]);\n"
                       "  mma_tf32(c, a_small, b_big[0], b_big[1]);\n")],
    },
}
VARIANTS["mlstm"] = {
    "one_pass": [(
        "      if (f < nf) mma_tf32(blk[f], a.small[s], b.big[f][s][0], b.big[f][s][1]);",
        "      (void)0;"), (
        "      if (f < nf) mma_tf32(blk[f], a.big[s], b.small[f][s][0], b.small[f][s][1]);",
        "      (void)0;")],
    "no_products": [(
        "      if (f < nf) mma_tf32(blk[f], a.small[s], b.big[f][s][0], b.big[f][s][1]);",
        "      (void)0;"), (
        "      if (f < nf) mma_tf32(blk[f], a.big[s], b.small[f][s][0], b.small[f][s][1]);",
        "      (void)0;"), (
        "      if (f < nf) mma_tf32(blk[f], a.big[s], b.big[f][s][0], b.big[f][s][1]);",
        "      (void)0;")],
    "ring3": [("constexpr int kRing = 2;", "constexpr int kRing = 3;")],
    "ring4": [("constexpr int kRing = 2;", "constexpr int kRing = 4;")],
    "state_lb2": [("__launch_bounds__(kThreads, 3)\nmlstm_bwd_state(",
                   "__launch_bounds__(kThreads, 2)\nmlstm_bwd_state(")],
    "pass_b8": [("kQ = 4, kB = 4, kPass = 1024;", "kQ = 4, kB = 8, kPass = 1024;")],
    "scores_per_block": [(
        "  mlstm_bwd_scores<<<(unsigned)ctas[1], kWideThreads, kScoreSmem, st>>>(",
        "  for (int rep = 1; rep < s.tiles; ++rep)\n"
        "    mlstm_bwd_scores<<<(unsigned)ctas[1], kWideThreads, kScoreSmem, st>>>(\n"
        "        sa, lff, seq, dkd, dvd, s.pp, s.slots, normalize);\n"
        "  mlstm_bwd_scores<<<(unsigned)ctas[1], kWideThreads, kScoreSmem, st>>>(")],
}
# The variants whose outputs are meant to be right, held to the plain
# backward like the kernel; each output's error is reported apart.
RIGHT = {"slstm": ("kernel", "baseline", "scalar_sends", "rn_accum"),
         "flash": ("kernel", "baseline", "tc_accum", "rn_accum", "four_pass"),
         "mlstm": ("kernel", "baseline", "ring3", "ring4", "state_lb2", "pass_b8",
                   "scores_per_block")}
OUTPUTS = {"slstm": ("dpre",), "flash": ("dq", "dk", "dv"),
           "mlstm": ("dq", "dk", "dv", "dlog_f")}
# (rows, clients): a round's stacked shape and one client's
SHAPES = ((1024, 16), (64, 1))
H, S, HD = 4, 64, 256
# the mLSTM backward's (B, H, S, dk, dv, normalize): xlstm-350m's training
# shape and hymba-1.5b's Mamba heads (chip_smoke.py phase 26)
MLSTM_SHAPES = ((8, 4, 128, 512, 512, True), (2, 25, 2048, 16, 64, False))


def inline_headers(src: str) -> str:
    """The source with each ``#include "x.cuh"`` of the kernels' headers
    replaced by the header's text, so that a copy compiles anywhere and
    an edit may reach the header's code."""
    for header in sorted(KERNELS.rglob("*.cuh")):
        src = src.replace(f'#include "{header.name}"',
                          header.read_text().replace("#pragma once\n", ""))
    return src


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


def entry(kind: str, lib: Path, text: str):
    """The C entry point of a built source. A flash source whose entry
    takes the window and the cap (``grouped``) gets (batch, Hq, Hkv, Sq,
    Sk, d, causal, window, softcap); an older one (batch * heads, Sq, Sk,
    d, causal)."""
    fn = getattr(ctypes.CDLL(str(lib)), {"slstm": "slstm_cell_bwd_f32",
                                          "flash": "flash_attention_bwd_f32",
                                          "mlstm": "mlstm_scan_bwd_f32"}[kind])
    fn.grouped = False
    if kind == "mlstm":
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    elif kind == "slstm":
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    elif "float softcap" in text:
        fn.grouped = True
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slstm_sets(torch, c, rows, n_sets):
    """n_sets of (saved, rt, dhs) from the saving forward kernel, and one
    r (for the plain backward)."""
    from repro_torch.kernels.slstm_cell import slstm_cell as slaunch

    sets = []
    for i in range(n_sets):
        gen = np.random.default_rng(100 + i)
        pre = torch.from_numpy(gen.standard_normal((rows, H, S, 4, HD), np.float32)
                               * 0.5).cuda()
        r = torch.from_numpy(gen.standard_normal((c, H, HD, 4 * HD), np.float32)
                             / np.float32(np.sqrt(HD))).cuda()
        _, saved = slaunch.slstm_cell_cuda(pre, r, save=True)
        dhs = torch.from_numpy(gen.standard_normal((rows, H, S, HD), np.float32)).cuda()
        sets.append((saved, r, r.transpose(-1, -2).contiguous(), dhs))
        del pre
    return sets


def flash_sets(torch, bh, n_sets):
    """n_sets of (q, k, v, out, dout, lse) with the forward kernel's out
    and log-sum-exp."""
    from repro_torch.kernels.flash_attention import flash_attention as flaunch

    sets = []
    for i in range(n_sets):
        gen = np.random.default_rng(200 + i)
        q, k, v, dout = (torch.from_numpy(gen.standard_normal(
            (bh, H, S, HD), np.float32)).cuda() for _ in range(4))
        out, lse = flaunch.flash_attention_cuda(q, k, v, causal=False, window=0,
                                                return_lse=True)
        sets.append((q, k, v, out, dout, lse))
    return sets


def mlstm_sets(torch, shape, n_sets):
    """n_sets of (q, k, v, log_f, h, dh) in (B H, S, d) rows, h the forward
    kernel's output (chip_smoke.mlstm_bwd_inputs)."""
    import chip_smoke
    from repro_torch.kernels.mlstm_scan import mlstm_scan as mlaunch

    return [chip_smoke.mlstm_bwd_inputs(torch, mlaunch, *shape, seed=300 + i)
            for i in range(n_sets)]


def flash_bwd_f64(q, k, v, out, dout, lse):
    """The plain backward of ``ref.flash_attention_bwd_ref`` (non-causal)
    in f64 on the same f32 inputs: the exact gradients to which the f32
    versions' errors are measured."""
    q, k, v, out, dout, lse = (x.double() for x in (q, k, v, out, dout, lse))
    scale = 1.0 / q.shape[-1] ** 0.5
    p = (q @ k.transpose(-1, -2) * scale - lse[..., None]).exp()
    ds = p * (dout @ v.transpose(-1, -2) - (dout * out).sum(-1, keepdim=True))
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ dout


def max_errs(kind, got, want) -> dict:
    """Max |got - want| of each output, in f64."""
    return {name: float((g.double() - w.double()).abs().max())
            for name, g, w in zip(OUTPUTS[kind], got, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slstm-baseline", type=Path, default=None,
                    help="another slstm_cell_bwd.cu to time and compare")
    ap.add_argument("--flash-baseline", type=Path, default=None,
                    help="another flash_attention_bwd.cu to time and compare")
    ap.add_argument("--mlstm-baseline", type=Path, default=None,
                    help="another mlstm_scan_bwd.cu to time and compare")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_ablation: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as mbwd
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.kernels.slstm_cell import ref as sref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = _build.nvcc()
    texts = {}
    for kind, src in SOURCES.items():
        text = inline_headers(src.read_text())
        texts[(kind, "kernel")] = text
        for name, edits in VARIANTS[kind].items():
            texts[(kind, name)] = variant_source(text, edits)
    for kind, base in (("slstm", args.slstm_baseline), ("flash", args.flash_baseline),
                       ("mlstm", args.mlstm_baseline)):
        if base is not None:
            texts[(kind, "baseline")] = inline_headers(base.read_text())
    with ThreadPoolExecutor(len(texts)) as ex:  # one nvcc a build, all at once
        built = dict(zip(texts, ex.map(
            lambda key: build(f"{key[0]}_{key[1]}", texts[key], nvcc,
                              _build.NVCC_FLAGS), texts)))
    results = []
    for kind in SOURCES:
        names = [n for (k, n) in built if k == kind]
        order = (["kernel"] + (["baseline"] if "baseline" in names else [])
                 + [n for n in names if n not in ("kernel", "baseline")]
                 + ["kernel"] + (["baseline"] if "baseline" in names else []))
        fns = {n: entry(kind, built[(kind, n)][0], texts[(kind, n)]) for n in names}
        for shape in (MLSTM_SHAPES if kind == "mlstm" else SHAPES):
            rows, c = (shape[0] * shape[1], 1) if kind == "mlstm" else shape
            if kind == "mlstm":
                b_, h_, s_, dk_, dv_, _ = shape
                per_set = 4 * b_ * h_ * s_ * (2 * dk_ + 3 * dv_ + 1)
            else:
                per_set = (rows * H * S * HD * 4 * (7 + 1) if kind == "slstm"
                           else rows * H * S * HD * 4 * 5)
            n_sets = max(1, -(-int(chip_smoke.ROTATE_BYTES) // per_set))
            sets = (slstm_sets(torch, c, rows, n_sets) if kind == "slstm"
                    else mlstm_sets(torch, shape, n_sets) if kind == "mlstm"
                    else flash_sets(torch, rows, n_sets))
            turn = {"i": 0}

            def nxt():
                turn["i"] = (turn["i"] + 1) % len(sets)
                return sets[turn["i"]]

            if kind == "mlstm":
                b_, h_, s_, dk_, dv_, norm = shape
                outs = [torch.empty_like(x) for x in sets[0][:4]]
                work = torch.empty(mbwd.work_bytes(b_ * h_, s_, dk_, dv_, norm) // 4,
                                   device="cuda")
                ds_ = torch.empty_like(sets[0][3])

                def call(fn, x=None, name=""):
                    q, k, v, lf, o, g = x or nxt()
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                             o.data_ptr(), g.data_ptr(), *(y.data_ptr() for y in outs),
                             work.data_ptr(), ds_.data_ptr(), b_ * h_, s_, dk_, dv_,
                             int(norm), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"mlstm {name}: CUDA error {err}")
                    return outs

                q, k, v, lf, o, g = sets[0]
                wants, dq_scale = mref.mlstm_scan_bwd_ref(q, k, v, lf, g, h=o,
                                                          normalize=norm, dq_scale=True)
                bound = [mref.mlstm_grad_error_bound(w, dq_scale if i == 0 else None)
                         for i, w in enumerate(wants)]
            elif kind == "slstm":
                res = torch.empty((rows, H, S, 4, HD), device="cuda")

                def call(fn, x=None, name=""):
                    saved, _, rt, dhs = x or nxt()
                    err = fn(saved.data_ptr(), rt.data_ptr(), dhs.data_ptr(),
                             res.data_ptr(), c, rows // c, H, S, HD,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"slstm {name}: CUDA error {err}")
                    return res

                want = sref.slstm_cell_bwd_ref(sets[0][0], sets[0][1], sets[0][3])
                bound = [sref.slstm_grad_error_bound(want)]
                wants = [want]
            else:
                dq, dk, dv = (torch.empty((rows, H, S, HD), device="cuda")
                              for _ in range(3))
                dd = torch.empty((rows, H, S), device="cuda")

                def call(fn, x=None, name=""):
                    q, k, v, o, g, lse = x or nxt()
                    dims = ((rows, H, H, S, S, HD, 0, 0, 0.0) if fn.grouped
                            else (rows * H, S, S, HD, 0))
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             g.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             *dims, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"flash {name}: CUDA error {err}")
                    return dq, dk, dv

                wants = fref.flash_attention_bwd_ref(*sets[0], causal=False)
                bound = [fref.flash_grad_error_bound(w) for w in wants]
            row = {"kernel": kind, "rows": rows, "clients": c, "us": {},
                   "device_us": {}, "max_abs_err": {}, "within_bound": {}}
            if kind == "mlstm":
                row["shape"] = list(shape)
            exact = flash_bwd_f64(*sets[0]) if kind == "flash" else None
            if exact is not None:  # the plain backward's own error
                row["max_abs_err_f64"] = {"plain": max_errs(kind, wants, exact)}
            for name in order:
                fn = fns[name]
                if name not in row["max_abs_err"] and name in RIGHT[kind]:
                    got = call(fn, sets[0], name)
                    got = (got,) if kind == "slstm" else got
                    torch.cuda.synchronize()
                    row["max_abs_err"][name] = max_errs(kind, got, wants)
                    row["within_bound"][name] = all(
                        bool(((g - w).abs() <= b).all())
                        for g, w, b in zip(got, wants, bound))
                    if exact is not None:
                        row["max_abs_err_f64"][name] = max_errs(kind, got, exact)
                ms = chip_smoke.cuda_time_ms(lambda fn=fn, name=name: call(fn, name=name),
                                             iters=10 if rows >= 1024 else 50, warmup=2)
                row["us"].setdefault(name, []).append(ms * 1e3)
                if name in ("kernel", "baseline") and name not in row["device_us"]:
                    dms = chip_smoke.counted_ms(
                        lambda fn=fn, name=name: call(fn, name=name),
                        iters=5 if rows >= 1024 else 20,
                        label=f"{kind} {name} {rows}")
                    row["device_us"][name] = None if dms is None else dms * 1e3
            results.append(row)
            where = (f"{shape}" if kind == "mlstm"
                     else f"({rows}, {H}, {S}, {HD}), {c} clients")
            print(f"{kind} {where}: " + ", ".join(
                f"{k} {'/'.join(f'{v:.1f}' for v in vs)} us"
                for k, vs in row["us"].items())
                + f"; device {row['device_us']}; max abs err {row['max_abs_err']}"
                + f"; within bound {row['within_bound']}", flush=True)
            del sets, wants, bound
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "cases": results, "ptxas": {
        f"{k}_{n}": chip_smoke.ptxas_summary(log) for (k, n), (_, log) in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
