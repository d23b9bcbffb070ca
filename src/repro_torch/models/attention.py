"""Multi-head attention with GQA, causal / bidirectional / sliding-window
masks, and a decode path against a (ring-buffer) KV cache (port of
``src/repro/models/attention.py``).

Where the reference computes attention in XLA (``gqa_sdpa``, one-shot
einsum, below ``CHUNKED_THRESHOLD``; ``chunked_gqa_sdpa``, an online
softmax over tiles, above it), the port runs every full-sequence and
every decode attention through the flash attention kernel
(``kernels/flash_attention``), in its (B, H, S, d) layout with K/V at
kv-head width. The cases:

- self-attention: causal, GQA, with the window for ``attn_kind ==
  "sliding"`` (Sq == Sk, so the kernel's end-aligned queries are the
  reference's);
- the encoder: non-causal; cross-attention: non-causal, Sq != Sk;
- decode: Sq = 1 against the cache's valid slots, ``[0, index]`` before
  the ring wraps and all of them after (the softmax does not depend on
  the slots' order, so no mask is needed).

Tensors keep the reference's (B, S, H, hd) layout between layers. The
kernel takes q in its (B, H, S, hd) layout (a transposed copy, except
at Sq = 1, where the transpose is already contiguous) and K/V where they
lie, through their strides: a decode step reads the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import dense, dense_init
from repro_torch.models.rope import apply_rope, rope_angles


def attn_init(gen, cfg, dtype, *, device):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device=device,
                         bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device,
                         bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device,
                         bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device=device),
    }


def _flash(q, k, v, *, causal: bool, window: int, softcap: float):
    """q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd)
    through the flash kernel's (B, H, S, hd) layout."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2)


def attend(p, cfg, x, positions, *, causal: bool, kv_x=None):
    """Full-sequence attention (training / prefill / encoder / cross).

    kv_x: source for K/V (cross-attention); defaults to x (self-attention).
    positions: (B, S) or (B, S, 3); None disables RoPE (e.g. cross-attn).
    Returns (out, (k, v)) so prefill can persist the cache.
    """
    hd = cfg.hd
    b, sq, _ = x.shape
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = dense(p["wq"], x).reshape(b, sq, cfg.n_heads, hd)
    k = dense(p["wk"], src).reshape(b, sk, cfg.n_kv_heads, hd)
    v = dense(p["wv"], src).reshape(b, sk, cfg.n_kv_heads, hd)
    if positions is not None and cfg.pos in ("rope", "mrope"):
        sections = cfg.mrope_sections if cfg.pos == "mrope" else None
        ang_q = rope_angles(positions, hd, cfg.rope_theta, sections)
        q = apply_rope(q, ang_q)
        if kv_x is None:
            k = apply_rope(k, ang_q)
    window = cfg.window if (cfg.attn_kind == "sliding" and causal) else 0
    out = _flash(q, k, v, causal=causal, window=window,
                 softcap=cfg.attn_logit_softcap)
    out = dense(p["wo"], out.reshape(b, sq, cfg.n_heads * hd))
    return out, (k, v)


# ---------------------------------------------------------------- decode ----

def init_kv_cache(cfg, batch: int, max_len: int, dtype, *, device):
    """Ring-buffer KV cache for one layer. For sliding attention the buffer
    is the window size; keys are stored post-RoPE (absolute positions)."""
    length = min(max_len, cfg.window) if cfg.attn_kind == "sliding" else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attend(p, cfg, x, cache, index: int, positions=None):
    """One-token decode. x (B, 1, d); cache {'k', 'v'} (B, L, Hkv, hd);
    index = number of tokens already in context. Returns (out, cache):
    the token's K/V written into slot ``index % L`` of the cache given
    (in place), and the kernel reads the valid slots where they lie."""
    hd = cfg.hd
    b = x.shape[0]
    length = cache["k"].shape[1]
    q = dense(p["wq"], x).reshape(b, 1, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    if cfg.pos in ("rope", "mrope"):
        if positions is None:
            positions = torch.full((b, 1), index, dtype=torch.int32,
                                   device=x.device)
        sections = cfg.mrope_sections if cfg.pos == "mrope" else None
        ang = rope_angles(positions, hd, cfg.rope_theta, sections)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    slot = index % length
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # valid slots: those already written (ring semantics)
    n = length if index + 1 >= length else index + 1
    out = _flash(q, cache["k"][:, :n].to(x.dtype), cache["v"][:, :n].to(x.dtype),
                 causal=False, window=0, softcap=cfg.attn_logit_softcap)
    out = dense(p["wo"], out.reshape(b, 1, cfg.n_heads * hd))
    return out, cache


def decode_cross_attend(p, cfg, x, cross_kv):
    """Decoder cross-attention against a precomputed encoder K/V cache
    (raw, kv-head width, as prefill produced it)."""
    hd = cfg.hd
    b = x.shape[0]
    q = dense(p["wq"], x).reshape(b, 1, cfg.n_heads, hd)
    k, v = cross_kv
    out = _flash(q, k.to(x.dtype), v.to(x.dtype), causal=False, window=0,
                 softcap=cfg.attn_logit_softcap)
    return dense(p["wo"], out.reshape(b, 1, cfg.n_heads * hd))
