"""Backbone: blocks composed into a language model (port of
``src/repro/models/backbone.py`` for ``block_type == "xlstm_pair"``).

    forward(params, cfg, batch)                    full sequence -> logits
    prefill(params, cfg, batch, max_len)           prompt -> logits, decode cache
    decode_step(params, cfg, tokens, cache, index) one-token serve step

plus ``make_serve_step``. Layers are stacked on a leading axis (each
leaf of ``params["layers"]`` is (n_layers, ...), as the reference's
``vmap`` init gives them) and walked by a Python loop where the
reference runs ``lax.scan``; the decode cache is stacked the same way.

Training (``loss_fn``, ``make_train_step``) needs backward kernels for
the mLSTM and sLSTM scans, and the attention, MoE, hybrid and
encoder-decoder families, frontends and rope are not ported yet: they
raise ``NotImplementedError`` naming ROADMAP item 15.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_index, tree_leaves, tree_map, tree_stack
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    dense,
    dense_init,
    embed,
    embedding_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.models.config import ArchConfig

_BLOCK = {
    "xlstm_pair": (B.xlstm_pair_init, B.xlstm_pair_block, B.xlstm_pair_decode,
                   B.xlstm_pair_cache, B.xlstm_pair_prefill),
}


def _check(cfg: ArchConfig) -> None:
    """Refuse what the port does not run yet, before any work."""
    if cfg.block_type not in _BLOCK:
        raise NotImplementedError(
            f"block_type {cfg.block_type!r} ({cfg.name}) is not ported: the "
            "port runs xlstm_pair; attention, MoE, hybrid and "
            "encoder-decoder blocks come with ROADMAP item 15")
    if cfg.frontend != "none" or cfg.pos == "learned":
        raise NotImplementedError(
            f"{cfg.name}: frontends and learned positions are not ported "
            "(ROADMAP item 15)")


def n_scan_layers(cfg: ArchConfig) -> int:
    if cfg.block_type == "xlstm_pair":
        if cfg.n_layers % 2:
            raise ValueError(f"xlstm_pair stacks pairs: n_layers {cfg.n_layers} is odd")
        return cfg.n_layers // 2
    return cfg.n_layers


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device=None):
    """Random parameters with the reference's keys, shapes and scales,
    drawn from ``gen`` (the values differ from JAX's threefry draws)."""
    _check(cfg)
    device = resolve_device(device)
    dtype = cfg.pdtype
    p = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                 device=device),
         "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  device=device)
    init_fn = _BLOCK[cfg.block_type][0]
    p["layers"] = tree_stack([init_fn(gen, cfg, dtype, device=device)
                              for _ in range(n_scan_layers(cfg))])
    return p


def _embed_inputs(params, cfg: ArchConfig, batch):
    """Returns (x (B, S, d), positions, loss_mask): tokens only, and the
    xlstm_pair blocks read no positions."""
    return embed(params["embed"], batch["tokens"], cfg.cdtype), None, None


def _lm_logits(params, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(x.dtype).T
    return dense(params["lm_head"], x)


def _layers(params):
    n = tree_leaves(params["layers"])[0].shape[0]
    return [tree_index(params["layers"], i) for i in range(n)]


def forward(params, cfg: ArchConfig, batch):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    _check(cfg)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    apply_fn = _BLOCK[cfg.block_type][1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params):
        x, a = apply_fn(lp, cfg, x, positions)
        aux = aux + a
    return _lm_logits(params, cfg, x), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Decode cache for the whole stack (leading axis = stacked layers),
    all zeros, as the reference's."""
    _check(cfg)
    device = resolve_device(device)
    single = _BLOCK[cfg.block_type][3](cfg, batch, max_len, dtype or cfg.cdtype,
                                       device=device)
    n = n_scan_layers(cfg)
    return tree_map(lambda x: torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                                          device=x.device), single)


def prefill(params, cfg: ArchConfig, batch, max_len: int, cache_dtype=None):
    """Process the prompt; returns (last-token logits (B, 1, V), cache,
    next_index)."""
    _check(cfg)
    cache_dtype = cache_dtype or cfg.cdtype
    x, positions, _ = _embed_inputs(params, cfg, batch)
    prefill_fn = _BLOCK[cfg.block_type][4]
    caches = []
    for lp in _layers(params):
        x, cache_l = prefill_fn(lp, cfg, x, positions, max_len, cache_dtype)
        caches.append(cache_l)
    logits = _lm_logits(params, cfg, x[:, -1:])
    return logits, tree_stack(caches), x.shape[1]


def decode_step(params, cfg: ArchConfig, tokens, cache, index):
    """tokens (B, 1) int; index: count of tokens already in context.
    Returns (logits (B, 1, V), new cache)."""
    _check(cfg)
    x = embed(params["embed"], tokens, cfg.cdtype)
    decode_fn = _BLOCK[cfg.block_type][2]
    new = []
    for i, lp in enumerate(_layers(params)):
        x, cache_l = decode_fn(lp, cfg, x, tree_index(cache, i), index, None)
        new.append(cache_l)
    return _lm_logits(params, cfg, x), tree_stack(new)


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, tokens, cache, index):
        return decode_step(params, cfg, tokens, cache, index)

    return serve_step
