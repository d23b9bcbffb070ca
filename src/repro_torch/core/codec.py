"""Wire codec (port of ``src/repro/core/codec.py``).

Lossy compression of the messages the VFL serving route and the
training round put on the wire:

- ``none``       4-byte floats, the uncompressed baseline;
- ``int8``       per-message symmetric int8 (scale = abs-max / 127);
- ``topk``       magnitude top-k sparsification (values + indices);
- ``int8_topk``  both composed: top-k selection, int8 payload values.

The round-trip (sparsify + quantize + dequantize in one pass per
flattened leaf) is the fused kernel in ``repro_torch.kernels.wire_codec``.
Byte accounting is analytic wire-format arithmetic on shapes.

Training rounds compress *deltas* with error feedback: each sender
compresses ``c_t = delta_t + resid_{t-1}`` and carries the compression
error ``resid_t = c_t - dec(c_t)`` into the next round. Residuals are
f32 trees in the federation's state.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.kernels.wire_codec.ops import scale_thresh, wire_codec_roundtrip
from repro_torch.kernels.wire_codec.ref import wire_codes

CODECS = ("none", "int8", "topk", "int8_topk")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static wire-codec configuration.

    name: one of CODECS. topk_frac: fraction of entries kept per leaf by
    the sparsifying codecs (k = max(1, ceil(frac * n))). error_feedback:
    carry the per-sender compression residual into the next round.
    """
    name: str = "none"
    topk_frac: float = 0.25
    error_feedback: bool = True

    def __post_init__(self):
        if self.name not in CODECS:
            raise ValueError(f"codec {self.name!r} not in {CODECS}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {self.topk_frac}")

    @property
    def enabled(self) -> bool:
        return self.name != "none"

    @property
    def quantize(self) -> bool:
        return self.name in ("int8", "int8_topk")

    @property
    def sparsify(self) -> bool:
        return self.name in ("topk", "int8_topk")


def make_codec(name: str, topk_frac: float = 0.25) -> CodecConfig:
    return CodecConfig(name=name, topk_frac=topk_frac)


def topk_k(n: int, frac: float) -> int:
    """Entries kept per flattened leaf of n elements."""
    return max(1, min(n, math.ceil(frac * n)))


# ------------------------------------------------------------ tree algebra --

def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def zeros_like_tree(tree):
    """f32 residual buffers matching a model tree's shapes."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


# ----------------------------------------------------------- wire roundtrip --

def _roundtrip_rows(x: torch.Tensor, rows: int, cfg: CodecConfig):
    flat = x.reshape(rows, -1)
    k = topk_k(flat.shape[1], cfg.topk_frac) if cfg.sparsify else None
    out = wire_codec_roundtrip(flat, k=k, quantize=cfg.quantize)
    return out.reshape(x.shape).to(x.dtype)


def encode_decode_stacked(tree, cfg: CodecConfig):
    """Lossy wire round-trip of a stacked tree (leaves (L, ...)).

    Each of the L rows is an independent message: per (row, leaf) scale
    and threshold, so one row's outlier magnitudes cannot wash out
    another's quantization grid. Returns a tree of the same shapes.
    """
    if not cfg.enabled:
        return tree
    return tree_map(lambda x: _roundtrip_rows(x, x.shape[0], cfg), tree)


def message_codes(x: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The decisions each row of x (L, ...) makes on the wire under
    ``cfg``, as an (L, N) int16 tensor: the int8 code of every entry (0
    where top-k drops it) for a quantizing codec, else the keep mask.
    Two sends of a row whose codes are equal differ only in the f32
    scale each carries, so their decoded values agree to its rounding;
    where they differ, a top-k or rounding decision flipped."""
    flat = x.reshape(x.shape[0], -1)
    k = topk_k(flat.shape[1], cfg.topk_frac) if cfg.sparsify else None
    keep, q = wire_codes(flat, scale_thresh(flat, k), quantize=cfg.quantize)
    if q is None:
        return keep.to(torch.int16)
    return torch.where(keep, q, torch.zeros_like(q)).to(torch.int16)


def encode_decode_tree(tree, cfg: CodecConfig):
    """Lossy wire round-trip of a single (unstacked) message tree."""
    if not cfg.enabled:
        return tree
    return tree_map(lambda x: _roundtrip_rows(x, 1, cfg), tree)


# ---------------------------------------------------------- codec stages ----

def _roundtrip(current, reference, resid, cfg: CodecConfig, enc_dec):
    """Shared delta + error-feedback wire round-trip.

    The receiver reconstructs ``reference + dec(c)``; we compute the
    mathematically-equal form ``current + resid - err`` (err = c - dec,
    the new residual) so that an identity codec reconstructs ``current``
    bit-exactly.
    """
    delta = tree_sub(current, reference)
    c = tree_add(delta, resid) if cfg.error_feedback else delta
    err = tree_sub(c, enc_dec(c, cfg))
    if cfg.error_feedback:
        return tree_sub(tree_add(current, resid), err), err
    return tree_sub(current, err), resid


def uplink_roundtrip(trained, base, resid, cfg: CodecConfig):
    """Client -> server wire for stacked candidates (leaves (L, ...)).

    Each row's message is its training delta vs. the base it started the
    round from, plus its error-feedback residual. Returns the decoded
    candidates (what the server aggregates/scores) and the new residual.
    """
    return _roundtrip(trained, base, resid, cfg, encode_decode_stacked)


def downlink_roundtrip(new_global, prev_global, resid, cfg: CodecConfig):
    """Server -> clients broadcast wire for one (unstacked) global tree.

    The message is the blend delta vs. the global the clients already
    hold, plus the server-side residual. Returns the clients' decoded
    view of the new global and the new residual.
    """
    return _roundtrip(new_global, prev_global, resid, cfg, encode_decode_tree)


# --------------------------------------------------------- byte accounting --

def leaf_payload_bytes(n: int, cfg: CodecConfig, dtype_bytes: int = 4) -> int:
    """Wire bytes for one flattened leaf of n elements.

    none: n dense values. int8: n 1-byte values + a 4-byte scale. topk:
    k (value, index) pairs — indices are 2 bytes while they fit, else 4.
    int8_topk: k (1-byte value, index) pairs + the 4-byte scale.
    """
    if not cfg.enabled:
        return dtype_bytes * n
    if cfg.name == "int8":
        return n + 4
    k = topk_k(n, cfg.topk_frac)
    idx_bytes = 2 if n <= 65536 else 4
    if cfg.name == "topk":
        return k * (dtype_bytes + idx_bytes)
    return 4 + k * (1 + idx_bytes)  # int8_topk


def tree_payload_bytes(tree, cfg: CodecConfig, dtype_bytes: int = 4) -> int:
    """Wire bytes for one message carrying every leaf of a model tree."""
    return sum(leaf_payload_bytes(math.prod(x.shape), cfg, dtype_bytes)
               for x in tree_leaves(tree))


def round_bytes(template, cfg: CodecConfig, n_up: int, n_down: int) -> dict:
    """Per-round traffic for a federation whose per-link message is one
    ``template`` tree (a single client's model groups, unstacked):
    n_up candidate uploads + n_down broadcast downloads."""
    per_msg = tree_payload_bytes(template, cfg)
    dense = tree_payload_bytes(template, CodecConfig())
    return {
        "bytes_per_message": per_msg,
        "bytes_up": n_up * per_msg,
        "bytes_down": n_down * per_msg,
        "bytes_per_round": (n_up + n_down) * per_msg,
        "dense_bytes_per_round": (n_up + n_down) * dense,
        "compression_ratio": dense / per_msg,
    }
