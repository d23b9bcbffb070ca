"""Training driver: language-model steps on one device (port of
``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --full --steps 50 --batch 8 --seq 128 [--ckpt-dir /tmp/ckpt]

    # the published width at the first 8 of its layers
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --full --layers 8 --steps 12 --batch 2 --seq 2048

    # the reduced config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 --device cpu

The reference's flags and defaults: ``--reduced`` is the default and
``--full`` builds the published width and depth (``--layers N`` keeps
the width and cuts the depth to the first N layers of every stack, a
flag the reference does not have); AdamW with a linear
warmup of 10 steps into a cosine decay over ``--steps``; weights random
from seed 0 (a ``torch.Generator``: the values differ from JAX's);
batches from ``build_batch`` and ``numpy.random.default_rng(0)``, the
reference's integers. Every config of ``repro_torch.configs`` trains:
the attention families (dense, MoE, VLM, hybrid, encoder-decoder) and
the xLSTM pairs. ``--model-parallel`` above 1 refuses: the port runs on
one device and has no mesh or sharding rules (ROADMAP item 16).
``--device`` defaults to CUDA and raises without it.

Checkpoints hold {params, opt_state} (``repro_torch.checkpoint``, the
reference's layout) every ``--ckpt-every`` steps; a run with a
``--ckpt-dir`` that holds one resumes from its latest step, and a legacy
params-only checkpoint restores the params with fresh optimizer moments
and schedule (it says so). Unlike the reference, which restarts its
batch stream from the seed on a resume (so a resumed run trains again
on the first batches), a resumed run draws and skips the batches of the
steps already taken: it continues the uninterrupted run's stream, and on
the CPU gives its losses and state bit for bit.

``main`` returns the run's history: a row a step with its loss, its
seconds (host clock around work that ends in a device synchronize) and
the launches of each CUDA kernel the step made (``KERNELS``; all zero on
the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ALIASES, get_config
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import flash_attention_bwd as _flash_bwd
from repro_torch.kernels.mlstm_scan import mlstm_scan as _mlstm
from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as _mlstm_bwd
from repro_torch.kernels.slstm_cell import slstm_cell as _slstm
from repro_torch.kernels.slstm_cell import slstm_cell_bwd as _slstm_bwd
from repro_torch.models import backbone as bb

# The CUDA kernels a training step launches, by name: their launch counters.
KERNELS = {"flash_attention": _flash, "flash_attention_bwd": _flash_bwd,
           "mlstm_scan": _mlstm, "mlstm_scan_bwd": _mlstm_bwd,
           "slstm_cell": _slstm, "slstm_cell_bwd": _slstm_bwd}


def build_batch(cfg, batch, seq, rng):
    """The reference's synthetic batch: tokens with a learnable bigram
    structure, and the VLM's patches or the encoder-decoder's frames, as
    numpy arrays drawn from ``rng``."""
    out = {}
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int64)
    toks[:, 2::2] = toks[:, 1:-1:2]  # learnable bigram structure
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.normal(0, 1, (batch, cfg.vision_tokens,
                                           cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 1, (batch, 64, cfg.frontend_dim)).astype(np.float32)
    out["tokens"] = toks[:, :-1].astype(np.int32)
    out["labels"] = toks[:, 1:].astype(np.int32)
    return out


def _launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train a language model")
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N layers of every stack")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the port trains on one "
            "device; the reference's mesh and sharding rules are not ported "
            "(ROADMAP item 16)")
    device = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch))
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 0 < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        cfg = cfg.replace(n_layers=args.layers, **(
            {"n_enc_layers": args.layers} if cfg.is_encdec else {}))
    print(f"arch={cfg.name} reduced={args.reduced} layers={cfg.n_layers} "
          f"params~{cfg.n_params/1e6:.1f}M device={device}")

    opt = optim.adamw(optim.linear_warmup_cosine(args.lr, warmup=10,
                                                 total_steps=args.steps))
    step_fn = bb.make_train_step(cfg, opt, microbatches=args.microbatches)
    params = bb.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                            device=device)
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        try:
            # params AND optimizer state together: params alone into a
            # fresh opt.init() would zero the AdamW moments and reset the
            # schedule step, silently replaying warmup
            restored = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt_state": opt_state},
                step=start)
            params, opt_state = restored["params"], restored["opt_state"]
            print(f"restored step {start} (params + opt_state) from {args.ckpt_dir}")
        except KeyError:  # legacy params-only layout: loudly degrade
            params = restore_checkpoint(args.ckpt_dir, params, step=start)
            print(f"restored step {start} from LEGACY params-only checkpoint "
                  f"{args.ckpt_dir}: optimizer moments/schedule step start "
                  "fresh (warmup replays)")

    rng = np.random.default_rng(0)
    for _ in range(start):  # the batches of the steps already taken
        build_batch(cfg, args.batch, args.seq, rng)
    history = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in build_batch(cfg, args.batch, args.seq, rng).items()}
        before = _launches()
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _sync(device)
        row = {"step": i + 1, "loss": float(metrics["loss"]),
               "total": float(metrics["total"]),
               "seconds": time.perf_counter() - ts,
               "launches": {k: n - before[k] for k, n in _launches().items()}}
        history.append(row)
        if (i + 1) % args.log_every == 0:
            print(f"step {i+1:5d} loss {row['loss']:.4f} "
                  f"({(time.perf_counter()-t0)/(i+1-start):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            {"params": params, "opt_state": opt_state},
                            {"arch": cfg.name, "loss": row["loss"]})
    print("done.")
    return {"cfg": cfg, "start": start, "history": history, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
