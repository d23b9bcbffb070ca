"""One-card dry run: size every (architecture x input shape) entry on the
meta device, and with ``--run`` build and time it on the card (the
port's counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each entry on 512 placeholder TPU devices).

    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all            # 40 records, meta only
    python -m repro_torch.launch.dryrun --all --run      # each entry that fits, on the card
    python -m repro_torch.launch.dryrun --blendfl        # the federated round

(with ``PYTHONPATH=src`` from the repository root). Each record holds
the entry's one-card share (one data shard's rows, ``specs.
one_card_shape``; ``--multi-pod`` takes the 32-shard share), its
parameter count and bytes, its argument bytes (parameters, optimizer
state, cache, batch), the bytes it holds at once (``held_terms``: what
a step or a call holds at its peak, term by term) against the card's
80 GB, and the roofline row (``launch/roofline.py``). Status: ``ok``,
``skip`` (the reference's skips) or ``does_not_fit`` (with the bytes);
``fail`` only if sizing raised. ``--run`` runs each fitting entry on
the card once to warm up (a train entry: one step), then times one call
between ``torch.cuda.synchronize`` calls and records the peak memory
against the count (``time_entry``, the routine ``chip_smoke.py`` times
its production entries with).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import optim, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.kernels.slstm_cell.slstm_cell import SAVE_SLOTS
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as SP
from repro_torch.models import backbone as bb
from repro_torch.models import attention, recurrent
from repro_torch.models import blocks as B
from repro_torch.models.rope import mrope_positions, text_positions


#: f32 copies of a microbatch's logits that the loss's backward holds at
#: once: the f32 logits ``logsumexp`` keeps, the gradient ``gather``'s
#: backward scatters into zeros, and ``logsumexp``'s backward's three:
#: the logits less the log-sum-exp, its exp and their product with the
#: incoming gradient
LOGIT_F32_COPIES = 5
#: one layer's backward holds its recomputed activations and, beside
#: them, their gradients in flight: this many times the activations
LAYER_BACKWARD_COPIES = 2


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _saved_bytes(fn) -> int:
    """The bytes of the storages autograd saves for the backward while
    ``fn()`` runs, each storage once."""
    seen = {}

    def pack(x):
        st = x.untyped_storage()
        seen[st._cdata] = st.nbytes()
        return x

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack,
                                                                       lambda x: x):
        fn()
    return sum(seen.values())


class _LiveBytes(TorchDispatchMode):
    """Within the mode, the bytes of the storages the ops make that are
    alive at once (each storage once, freed when its last tensor goes),
    and their peak."""

    def __init__(self):
        super().__init__()
        self.refs, self.size, self.live, self.peak = {}, {}, 0, 0

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                key = t.untyped_storage()._cdata
                if key not in self.refs:
                    self.refs[key] = 0
                    self.size[key] = t.untyped_storage().nbytes()
                    self.live += self.size[key]
                    self.peak = max(self.peak, self.live)
                self.refs[key] += 1
                weakref.finalize(t, self._drop, key)
        return out


class _MetaFn(torch.autograd.Function):
    """A kernel's autograd Function on meta tensors: ``make(*inputs)``
    gives (the output, the tensors the CUDA Function saves for its
    backward); the forward saves those and computes nothing. Its
    backward (which the sizing never runs) gives each input an empty
    gradient."""

    @staticmethod
    def forward(ctx, make, *inputs):
        out, saved = make(*inputs)
        ctx.save_for_backward(*saved)
        ctx.inputs = [(x.shape, x.dtype) for x in inputs]
        return out

    @staticmethod
    def backward(ctx, dout):
        return (None, *(torch.empty(shape, dtype=dtype, device="meta")
                        for shape, dtype in ctx.inputs))


def _records_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


@contextlib.contextmanager
def _meta_kernels():
    """Within the block, the kernel wrappers the models call (which take
    CUDA or CPU tensors) are stand-ins for meta tensors that compute
    nothing. Without a gradient they allocate what each wrapper's CUDA
    path allocates: flash attention q's contiguous copy and the output;
    the mLSTM scan its inputs' f32 copies, the f32 output and the final
    state; the sLSTM cell the output and the final state. Where a
    gradient is recorded they go through ``_MetaFn`` and save what the
    kernels' autograd Functions save on the card: flash attention q, k,
    v, the output and the f32 log-sum-exp (``FlashAttentionFn``); the
    mLSTM scan its inputs cast to f32 and the f32 output
    (``MLSTMScanFn``); the sLSTM cell the output, each step's gate sums
    and state (SAVE_SLOTS f32 a unit) and r (``SLSTMCellFn``)."""
    def flash(q, k, v, *, causal=True, window=0, softcap=0.0):
        def make(q, k, v):
            out = torch.empty(q.shape, dtype=q.dtype, device="meta")
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
            return out, (q, k, v, out, lse)

        if _records_grad(q, k, v):
            return _MetaFn.apply(make, q, k, v)
        return torch.empty_like(q.contiguous())

    def mlstm(q, k, v, log_f, *, chunk=64, normalize=True, return_state=False):
        def make(q, k, v, lf):
            out = torch.empty(v.shape, dtype=torch.float32, device="meta")
            return out, (q, k, v, lf, out)

        if _records_grad(q, k, v, log_f):
            return _MetaFn.apply(make, *(x.float() for x in (q, k, v, log_f)))
        ins = [x.float().contiguous() for x in (q, k, v, log_f)]  # noqa: F841
        b, h, _, dk = q.shape
        out = torch.empty(v.shape, dtype=torch.float32, device="meta")
        if not return_state:
            return out
        return out, (torch.empty((b, h, dk, v.shape[-1]), device="meta"),
                     torch.empty((b, h, dk), device="meta"))

    def slstm(pre_x, r, initial_state=None, return_state=False):
        b, h, s, _, hd = pre_x.shape

        def make(pre_x, r):
            out = torch.empty((b, h, s, hd), dtype=pre_x.dtype, device="meta")
            steps = torch.empty((b, h, s, SAVE_SLOTS, hd), dtype=torch.float32,
                                device="meta")
            return out, (out, steps, r)

        if _records_grad(pre_x, r):
            return _MetaFn.apply(make, pre_x, r)
        out = torch.empty((b, h, s, hd), dtype=pre_x.dtype, device="meta")
        if not return_state:
            return out
        return out, tuple(torch.empty((b, h, hd), device="meta") for _ in range(4))

    saved = attention.flash_attention, recurrent.mlstm_scan, recurrent.slstm_cell
    attention.flash_attention, recurrent.mlstm_scan, recurrent.slstm_cell = (
        flash, mlstm, slstm)
    try:
        yield
    finally:
        attention.flash_attention, recurrent.mlstm_scan, recurrent.slstm_cell = saved


def layer_work_bytes(cfg, params, rows: int, positions: int, max_len: int) -> int:
    """One layer's work without a gradient: the most bytes a prefill of
    ``rows`` x ``positions`` into a ``max_len``-slot cache holds at once
    inside layer 0 beside what it was given (its input included, and the
    layer's cache, which the stacked cache then takes in), traced on the
    meta device (the kernels allocating there what their CUDA path does,
    ``_meta_kernels``); an encoder-decoder: the larger of an encoder
    layer and a decoder layer. At one position (a decode step) the
    forward block's (an encoder-decoder's decoder block)."""
    def run(fn, *shapes):
        xs = [torch.empty((rows, n, cfg.d_model), dtype=cfg.cdtype, device="meta")
              for n in shapes]
        live = _LiveBytes()
        with torch.no_grad(), _meta_kernels(), live:
            out = fn(*xs)
        del out
        return live.peak + sum(nbytes(x) for x in xs)

    cdt = torch.bfloat16
    if cfg.is_encdec:  # a decode step runs the decoder only
        frames = SP.ENC_FRAMES
        dec = bb._layers(params["dec_layers"])[0]
        if positions == 1:
            return run(lambda x, e: B.dec_block(dec, cfg, x, e, None), 1, frames)
        enc = bb._layers(params["enc_layers"])[0]
        return max(run(lambda x: B.enc_block(enc, cfg, x, None), frames),
                   run(lambda x, e: B.dec_block_prefill(dec, cfg, x, e, None, max_len,
                                                        cdt), positions, frames))
    lp = bb._layers(params["layers"])[0]
    pos = _positions(cfg, rows, positions)
    if positions == 1:
        return run(lambda x: bb._BLOCK[cfg.block_type][1](lp, cfg, x, pos), 1)
    prefill_fn = bb._BLOCK[cfg.block_type][4]
    return run(lambda x: prefill_fn(lp, cfg, x, pos, max_len, cdt), positions)


def _positions(cfg, rows, positions, device="meta"):
    if cfg.pos == "mrope":  # a decode step's one position is text
        n_vis = cfg.vision_tokens if positions > cfg.vision_tokens else 0
        return mrope_positions(rows, n_vis, positions - n_vis, device=device)
    return text_positions(rows, positions, device=device)


def layer_activation_bytes(cfg, params, rows: int, positions: int) -> int:
    """One layer's activations at ``rows`` x ``positions``: the bytes its
    forward saves for the backward (every intermediate a backward reads,
    the compute-dtype copies of its weights included), traced through
    layer 0 on the device of ``params``: the meta device for sizing,
    where the kernels' stand-ins (``_meta_kernels``) save what their
    autograd Functions save on the card and compute nothing. An
    encoder-decoder: the larger of an encoder layer (at ENC_FRAMES
    frames) and a decoder layer (its cross attention over them)."""
    device = tree_leaves(params)[0].device
    with _meta_kernels() if device.type == "meta" else contextlib.nullcontext():
        return _layer_activation_bytes(cfg, params, rows, positions, device)


def _layer_activation_bytes(cfg, params, rows, positions, device) -> int:
    def grad_leaves(tree):
        return tree_map(lambda x: x.detach().requires_grad_(True), tree)

    def x_in(n):
        return torch.zeros((rows, n, cfg.d_model), dtype=cfg.cdtype, device=device,
                           requires_grad=True)

    if cfg.is_encdec:
        frames = SP.ENC_FRAMES
        enc = grad_leaves(bb._layers(params["enc_layers"])[0])
        dec = grad_leaves(bb._layers(params["dec_layers"])[0])
        return max(_saved_bytes(lambda: B.enc_block(enc, cfg, x_in(frames), None)),
                   _saved_bytes(lambda: B.dec_block(dec, cfg, x_in(positions),
                                                    x_in(frames), None)))
    lp = grad_leaves(bb._layers(params["layers"])[0])
    pos = _positions(cfg, rows, positions, device)
    apply_fn = bb._BLOCK[cfg.block_type][1]
    return _saved_bytes(lambda: apply_fn(lp, cfg, x_in(positions), pos))


def held_terms(cfg, shape, params=None, microbatches: int = 1) -> dict:
    """The bytes an entry of ``specs.make_entry`` holds at its peak on one
    card, term by term (meta tensors; nothing is allocated), and
    ``held``, their count.

    A train step (bf16 compute, ``remat``, the in-place AdamW step) holds
    throughout
      params       the f32 parameters;
      moments      AdamW's two f32 moments and its step;
      grads        one f32 gradient tree, also the microbatches'
                   accumulator (each gradient is added into it as the
                   backward reaches its leaf);
      batch        the step's batch;
    and, while a microbatch (``rows`` = batch / microbatches) runs,
      remat        what ``remat`` keeps: each layer's input in the
                   compute dtype (rows x positions x d_model), and an
                   encoder-decoder's encoder inputs (at its frames) and
                   output;
    with the larger of two phases that do not overlap in time:
      logits       the loss's backward: LOGIT_F32_COPIES f32 copies of
                   the text positions' logits (rows x text x vocab x 4
                   each; the forward, with the compute-dtype logits of
                   every position, holds less), and the head's weights
                   in the compute dtype (``head``: the product's cast
                   copy, which its backward keeps);
      layer        one layer's backward: LAYER_BACKWARD_COPIES times its
                   recomputed activations (``layer_activation_bytes``);
    or, after the backward, the optimizer's
      optimizer    per-leaf temporaries: two f32 copies of the largest
                   leaf (sqrt(v^) + eps and the weight decay term).
    held = params + moments + grads + batch + max(remat + max(logits,
    layer), optimizer).

    A prefill holds params, batch, the cache it returns (cache), one
    layer's work at the prompt (layer: ``layer_work_bytes``) and the
    last position's logits with the head's cast weights (logits). A
    decode step: params, the cache it updates, the token batch, one
    layer's work at one position and the logits."""
    params = SP.params_specs(cfg) if params is None else params
    n_params = sum(x.numel() for x in tree_leaves(params))
    c = torch.empty((), dtype=cfg.cdtype).element_size()
    v = cfg.vocab_size
    head = c * v * cfg.d_model  # the head (or tied table) cast for its product
    t = {"params": nbytes(params)}
    if shape.kind == "train":
        rows = shape.batch // microbatches
        batch = SP.train_batch_specs(cfg, shape)
        text = batch["tokens"].shape[1]
        pos = text + (cfg.vision_tokens if cfg.frontend == "vision_stub" else 0)
        t["moments"] = 2 * 4 * n_params + 4
        t["grads"] = 4 * n_params
        t["batch"] = nbytes(batch)
        kept = bb.n_scan_layers(cfg) * pos
        if cfg.is_encdec:  # the encoder's layer inputs and its output
            kept += (cfg.n_enc_layers + 1) * SP.ENC_FRAMES
        t["remat"] = rows * kept * cfg.d_model * c
        t["logits"] = LOGIT_F32_COPIES * rows * text * v * 4 + head
        t["layer"] = LAYER_BACKWARD_COPIES * layer_activation_bytes(cfg, params,
                                                                    rows, pos)
        t["optimizer"] = 2 * 4 * max(x.numel() for x in tree_leaves(params))
        t["held"] = (t["params"] + t["moments"] + t["grads"] + t["batch"]
                     + max(t["remat"] + max(t["logits"], t["layer"]),
                           t["optimizer"]))
        return t
    if shape.kind == "prefill":
        batch = SP.prefill_batch_specs(cfg, shape)
        t["batch"] = nbytes(batch)
        t["cache"] = nbytes(bb.init_cache(cfg, shape.batch, shape.seq, torch.bfloat16,
                                          enc_len=SP.ENC_FRAMES, device="meta"))
        pos = shape.seq
    else:
        d = SP.decode_specs(cfg, shape)
        t["batch"] = nbytes(d["tokens"]) + nbytes(d["index"])
        t["cache"] = nbytes(d["cache"])
        pos = 1
    t["layer"] = layer_work_bytes(cfg, params, shape.batch, pos, shape.seq)
    t["logits"] = shape.batch * v * c + head
    t["held"] = sum(t.values())
    return t


def size_entry(cfg, shape, microbatches: int = 1) -> dict:
    """Meta-device sizing of ``cfg`` at ``shape`` (a one-card share):
    parameter count and bytes, argument bytes, the bytes held at once
    (``held_terms``; ``held_bytes``, and ``card_share`` of the card) and
    the roofline row, whose memory term counts the arguments read and
    the outputs written once (a train step writes its parameters and
    moments back; a prefill its cache and logits)."""
    params = SP.params_specs(cfg)
    terms = held_terms(cfg, shape, params, microbatches)
    rec = {"n_params": sum(x.numel() for x in tree_leaves(params)),
           "param_bytes": terms["params"]}
    if shape.kind == "train":
        arg_bytes = terms["params"] + terms["moments"] + terms["batch"]
        out_bytes = terms["params"] + terms["moments"]
    else:
        rec["cache_bytes"] = terms["cache"]
        arg_bytes = terms["params"] + terms["batch"] + (
            terms["cache"] if shape.kind == "decode" else 0)
        logits = shape.batch * cfg.vocab_size * 2  # bf16, the last position
        out_bytes = logits + (terms["cache"] if shape.kind == "prefill"
                              else 0)  # decode updates its cache
    rec["arg_bytes"] = arg_bytes
    rec["held_terms"] = {k: v for k, v in terms.items() if k != "held"}
    rec["held_bytes"] = terms["held"]
    rec["card_share"] = rec["held_bytes"] / rl.CARD_BYTES
    rec["roofline"] = rl.roofline(cfg, shape, params, arg_bytes + out_bytes,
                                  enc_len=SP.ENC_FRAMES).row()
    return rec


def materialize(cfg, shape, device, *, seed: int = 0, params=None):
    """Real arguments of ``specs.make_entry(cfg, shape)``'s function on
    ``device``, from ``seed``: random parameters (unless given), random
    tokens (and, for training, labels) and patches or frames; for
    training a fresh AdamW state (zero moments, step 0); for decode a
    bf16 cache of random normal K/V (the reference's decode entry takes
    its cache as an argument; recurrent states, f32, start at zero) at
    index seq - 1. Returns the argument tuple."""
    rng = np.random.default_rng(seed)
    if params is None:
        params = bb.init_params(torch.Generator(device=device).manual_seed(seed),
                                cfg, device=device)

    def fill(spec):
        if spec.dtype == torch.int32:
            hi = cfg.vocab_size if spec.dim() == 2 else 1
            return torch.from_numpy(rng.integers(0, hi, tuple(spec.shape))
                                    .astype(np.int32)).to(device)
        return torch.from_numpy(rng.standard_normal(tuple(spec.shape))
                                .astype(np.float32)).to(device, spec.dtype)

    if shape.kind == "train":
        return (params, optim.adamw(1e-4).init(params),
                {k: fill(v) for k, v in SP.train_batch_specs(cfg, shape).items()})
    if shape.kind == "prefill":
        return params, {k: fill(v) for k, v in SP.prefill_batch_specs(cfg, shape).items()}
    d = SP.decode_specs(cfg, shape)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def cache_leaf(spec):
        if spec.dtype == torch.bfloat16:
            return torch.randn(tuple(spec.shape), generator=gen, device=device,
                               dtype=torch.bfloat16)
        return torch.zeros(tuple(spec.shape), dtype=spec.dtype, device=device)

    return (params, fill(d["tokens"]), tree_map(cache_leaf, d["cache"]),
            shape.seq - 1)


def time_entry(fn, args, *, steps: int = 1, warmup: bool = True) -> tuple:
    """``fn(*args)`` on the card: a warm-up call (``warmup`` False: the
    caller has warmed it up), then ``steps`` calls, each timed between
    synchronizations, under ``torch.no_grad`` (a train step records its
    gradient all the same: ``make_train_step`` turns autograd on
    inside). Returns ({"ms": the median, "ms_all", "peak_gb":
    the peak memory of the timed calls, all that is allocated counted},
    the last call's output)."""
    with torch.no_grad():
        if warmup:
            fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return ({"ms": float(np.median(times)), "ms_all": times,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, out)


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            run: bool = False) -> dict:
    """Size one (arch, shape) entry on the meta device at its one-card
    share; with ``run`` also build and time it on the card. Returns the
    record."""
    shape = SP.SHAPES[shape_name]
    cfg = SP.one_card_config(arch, shape)
    rec = {"arch": arch, "shape": shape_name,
           "share": f"1 of {SP.MULTI_POD_DATA_SHARDS if multi_pod else SP.DATA_SHARDS}"
                    " data shards"}
    if cfg is None:
        rec.update(status="skip", reason="no sub-quadratic form (see DESIGN.md)")
        print(f"[{arch} x {shape_name}] skip", flush=True)
        return rec
    oshape = SP.one_card_shape(shape, multi_pod)
    rec.update(variant=SP.applicability(get_config(arch), shape),
               batch=oshape.batch, seq=oshape.seq,
               compute_dtype=cfg.compute_dtype, moe_groups=cfg.moe_groups,
               microbatches=SP.default_microbatches(arch, shape))
    rec.update(size_entry(cfg, oshape, rec["microbatches"]))
    fits = rec["held_bytes"] <= rl.CARD_BYTES
    rec["status"] = "ok" if fits else "does_not_fit"
    if oshape.kind == "train":
        rec["entry"] = (f"train step: bf16 compute, remat, in-place AdamW, "
                        f"{rec['microbatches']} microbatches")
    if run and fits:
        fn, _ = SP.make_entry(cfg, oshape, rec["microbatches"])
        device = resolve_device(None)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        res, _ = time_entry(fn, materialize(cfg, oshape, device))
        tokens = oshape.batch * (1 if oshape.kind == "decode" else oshape.seq)
        peak = res["peak_gb"] * 1e9 - base
        rec["run"] = {"ms": res["ms"], "peak_gb": peak / 1e9,
                      "peak_over_held": peak / rec["held_bytes"],
                      "tokens_per_s": tokens / (res["ms"] / 1e3),
                      "roofline_share": rec["roofline"]["bound_ms"] / res["ms"]}
        torch.cuda.empty_cache()
    r = rec["roofline"]
    print(f"[{arch} x {shape_name} @ {oshape.batch} x {oshape.seq}] "
          f"{rec['status']} params {rec['n_params']} held "
          f"{rec['held_bytes'] / 1e9:.2f} GB ({rec['card_share']:.3f} of the "
          f"card) terms(ms) c={r['t_compute_ms']:.2f} m={r['t_memory_ms']:.2f}"
          f" -> {r['bottleneck']}"
          + (f"; run {rec['run']['ms']:.2f} ms, peak {rec['run']['peak_gb']:.2f}"
             f" GB ({rec['run']['peak_over_held']:.3f} of held)" if "run" in rec
             else ""), flush=True)
    return rec


def run_blendfl_round(n_clients: int = SP.DATA_SHARDS) -> dict:
    """Size the paper's own federated round (one client a data shard of
    the reference's mesh, all on one card) on the meta device."""
    _, (state, batch), spec = SP.make_blendfl_entry(n_clients=n_clients)
    rec = {"arch": "blendfl_round", "shape": f"C{n_clients}",
           "state_bytes": nbytes(state), "batch_bytes": nbytes(batch),
           "n_params_stacked": sum(x.numel() for x in tree_leaves(state["models"]))}
    rec["held_bytes"] = rec["state_bytes"] + rec["batch_bytes"]
    rec["card_share"] = rec["held_bytes"] / rl.CARD_BYTES
    rec["status"] = "ok" if rec["held_bytes"] <= rl.CARD_BYTES else "does_not_fit"
    print(f"[blendfl_round C{n_clients}] {rec['status']} state "
          f"{rec['state_bytes'] / 1e9:.3f} GB, batch "
          f"{rec['batch_bytes'] / 1e9:.3f} GB", flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (dashed or underscored)")
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the share of the 2 x 16 x 16 mesh: 32 data shards")
    ap.add_argument("--all", action="store_true", help="full 40-pair sweep")
    ap.add_argument("--blendfl", action="store_true", help="the federated round entry")
    ap.add_argument("--run", action="store_true",
                    help="also build and time each fitting entry on the card")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    records = []

    def emit(rec):
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.blendfl:
        emit(run_blendfl_round(SP.MULTI_POD_DATA_SHARDS if args.multi_pod
                               else SP.DATA_SHARDS))
        return records

    archs = (ARCH_IDS if (args.all or not args.arch)
             else [ALIASES.get(args.arch, args.arch)])
    shapes = list(SP.SHAPES) if (args.all or not args.shape) else [args.shape]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            try:
                emit(run_one(arch, shape, multi_pod=args.multi_pod, run=args.run))
            except Exception:
                n_fail += 1
                print(f"[{arch} x {shape}] FAIL", flush=True)
                traceback.print_exc()
                emit({"arch": arch, "shape": shape, "status": "fail",
                      "error": traceback.format_exc()[-2000:]})
    counts = {s: sum(r["status"] == s for r in records)
              for s in ("ok", "skip", "does_not_fit")}
    print(f"\ndry-run: {counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['does_not_fit']} does_not_fit, {n_fail} fail / "
          f"{len(records)} total")
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
