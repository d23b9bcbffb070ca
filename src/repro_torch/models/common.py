"""Core functional layers: linear, RMS norm, embedding, activations and
the task losses.

Params are plain nested dicts of tensors with the reference's keys
(``src/repro/models/common.py``); every layer is an (init, apply) pair
of functions. Random init draws from an explicit ``torch.Generator`` on
the generator's own device and moves the result to ``device``, so one
seed gives the same weights on every device. The numbers differ from
the reference's JAX threefry draws; parity tests carry weights across
with ``repro_torch.convert``. On the ``meta`` device an init draws
nothing: it gives tensors of the shapes and dtypes only, the port's
counterpart of ``jax.eval_shape`` over the reference's init.
"""
from __future__ import annotations

import math

import torch


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen``, on the
    generator's device; on the meta device, no draw (``gen`` may be
    None)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               device, bias: bool = False, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = normal(gen, (d_in, d_out), device) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, dtype, *, device):
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["g"].float()).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype, *, device):
    table = normal(gen, (vocab, d), device) * 0.02
    return {"table": table.to(device=device, dtype=dtype)}


def embed(p, tokens, compute_dtype):
    return p["table"][tokens.long()].to(compute_dtype)


def activation(name: str):
    """The reference's activations by name; ``gelu`` is its tanh form
    (``jax.nn.gelu`` defaults to it)."""
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (nemotron-4)
        return lambda x: torch.square(torch.relu(x))
    if name == "silu":
        return torch.nn.functional.silu
    raise ValueError(name)


def softmax_cross_entropy(logits, labels):
    """logits (..., V), accumulated in f32; labels int (...,). Returns (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - picked


def sigmoid_bce(logits, targets):
    logits = logits.float()
    targets = targets.float()
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
