"""Serving driver: prefill + batched greedy decode on one device (port of
``src/repro/launch/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch phi4-mini-3.8b \
        --full --batch 8 --prompt-len 512 --gen 32 --max-len 544

    # a reduced smoke config on the CPU (any of configs.ALIASES)
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch hymba-1.5b \
        --batch 2 --prompt-len 16 --gen 4 --device cpu

Prefill runs the prompt and builds the decode cache (a ring-buffer KV
cache per attention layer, the cross-attention K/V of an encoder-decoder,
the final recurrent states of the Mamba heads and of the mLSTM and
sLSTM), then ``decode_step`` extends it one token at a time. Every
family of ``configs.ARCH_IDS`` is served: the VLM gets a prefix of
``vision_tokens`` random patch embeddings and the encoder-decoder 64
random frames, as the reference's ``main`` builds them. Weights are
random, drawn from ``--seed``.

``--device`` defaults to CUDA and raises without it. Times are host
clock around work that ends in ``torch.cuda.synchronize()``. Greedy
decoding (``--temperature 0``) is held against the reference; with a
temperature the port samples from a ``torch.Generator``, whose draws
differ from ``jax.random``'s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, get_config
from repro_torch.models import backbone as bb


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_tokens(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def generate(params, cfg, tokens, *, gen: int, max_len: int, inputs=None,
             temperature: float = 0.0, generator=None, hook=None) -> dict:
    """Prefill ``tokens`` (B, S) on their device, with the model's other
    ``inputs`` (``patches`` for a VLM, ``frames`` for an encoder-decoder),
    then ``gen`` decode steps.

    Returns {"tokens": (B, 1 + gen) int32 (the token after the prompt,
    then one per step), "prefill_s", "decode_s": seconds a step}.
    ``hook(stage, i)`` runs after prefill ("prefill", 0) and after each
    decode step ("decode", i), once the device has finished it."""
    device = tokens.device
    serve_step = bb.make_serve_step(cfg)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache, index = bb.prefill(params, cfg,
                                          {"tokens": tokens, **(inputs or {})},
                                          max_len=max_len)
        nxt = _next_tokens(logits, temperature, generator)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        if hook is not None:
            hook("prefill", 0)
        out, steps = [nxt], []
        for i in range(gen):
            t0 = time.perf_counter()
            logits, cache = serve_step(params, nxt, cache, index + i)
            nxt = _next_tokens(logits, temperature, generator)
            _sync(device)
            steps.append(time.perf_counter() - t0)
            if hook is not None:
                hook("decode", i)
            out.append(nxt)
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s": steps, "logits": logits, "cache": cache}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="prefill + decode an LM")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch))
    if args.reduced:
        cfg = cfg.reduced()
    params = bb.init_params(torch.Generator(device=device).manual_seed(args.seed),
                            cfg, device=device)
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (args.batch, args.prompt_len))
                              .astype(np.int32)).to(device)
    inputs = {}
    if cfg.frontend == "vision_stub":
        inputs["patches"] = rng.normal(0, 1, (args.batch, cfg.vision_tokens,
                                              cfg.frontend_dim))
    if cfg.is_encdec:
        inputs["frames"] = rng.normal(0, 1, (args.batch, 64, cfg.frontend_dim))
    inputs = {k: torch.from_numpy(v.astype(np.float32)).to(device)
              for k, v in inputs.items()}
    res = generate(params, cfg, tokens, gen=args.gen, max_len=args.max_len,
                   inputs=inputs, temperature=args.temperature,
                   generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{res['prefill_s']:.4f}s on {device}")
    dt = sum(res["decode_s"])
    print(f"decoded {args.gen} tokens x{args.batch} in {dt:.4f}s "
          f"({args.gen * args.batch / max(dt, 1e-9):.1f} tok/s)")
    for row in res["tokens"][: min(args.batch, 2)].cpu().numpy():
        print("  ", row.tolist())
    return res


if __name__ == "__main__":
    main()
