"""Wire codec, serving part (port of ``src/repro/core/codec.py``).

Lossy compression of the messages the VFL serving route puts on the
wire:

- ``none``       4-byte floats, the uncompressed baseline;
- ``int8``       per-message symmetric int8 (scale = abs-max / 127);
- ``topk``       magnitude top-k sparsification (values + indices);
- ``int8_topk``  both composed: top-k selection, int8 payload values.

The round-trip (sparsify + quantize + dequantize in one pass per
flattened leaf) is the fused kernel in ``repro_torch.kernels.wire_codec``.
Byte accounting is analytic wire-format arithmetic on shapes. The
training side (error-feedback uplink/downlink) comes with the training
slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.wire_codec.ops import wire_codec_roundtrip

CODECS = ("none", "int8", "topk", "int8_topk")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static wire-codec configuration.

    name: one of CODECS. topk_frac: fraction of entries kept per leaf by
    the sparsifying codecs (k = max(1, ceil(frac * n))). error_feedback:
    carry the per-sender compression residual into the next round (a
    training-side field, kept so configs match the reference).
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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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
    return _tree_map(lambda x: _roundtrip_rows(x, x.shape[0], cfg), tree)


def encode_decode_tree(tree, cfg: CodecConfig):
    """Lossy wire round-trip of a single (unstacked) message tree."""
    if not cfg.enabled:
        return tree
    return _tree_map(lambda x: _roundtrip_rows(x, 1, cfg), tree)


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
               for x in _leaves(tree))
