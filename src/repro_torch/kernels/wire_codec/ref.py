"""Plain PyTorch version of the fused wire-codec round-trip kernel.

The CPU path of ``ops.wire_codec_roundtrip`` and the oracle the CUDA
kernel is held against on the card. Both divisions are tensor-by-tensor
so that they are IEEE divisions on every device (PyTorch computes
``number / tensor`` and, on CUDA, ``tensor / number`` through a
reciprocal), matching the kernel's arithmetic exactly.
"""
from __future__ import annotations

import torch


def wire_codes(x, scale_thresh, *, quantize: bool):
    """What the round trip encodes, per entry of x (L, N): the keep mask
    (|x| >= thresh) and, when ``quantize``, the int8 codes
    q = round(x * 127/scale) (half to even) as f32; else None."""
    xf = x.float()
    scale = scale_thresh[:, 0:1].float()
    thresh = scale_thresh[:, 1:2].float()
    keep = xf.abs() >= thresh
    q = None
    if quantize:
        c127 = torch.full_like(scale, 127.0)
        q = torch.clamp(torch.round(xf * (c127 / scale)), -127.0, 127.0)
    return keep, q


def wire_codec_ref(x, scale_thresh, *, quantize: bool):
    """x (L, N); scale_thresh (L, 2) per-row [int8 scale, top-k |x|
    threshold]. Returns the decoded (L, N) reconstruction in x's dtype:
    entries with |x| < thresh are dropped; kept entries are optionally
    round-tripped through symmetric int8 at q = round(x * 127/scale)
    (half to even), dequantized as q * scale/127."""
    keep, q = wire_codes(x, scale_thresh, quantize=quantize)
    xf = x.float()
    if quantize:
        scale = scale_thresh[:, 0:1].float()
        xf = q * (scale / torch.full_like(scale, 127.0))
    return torch.where(keep, xf, torch.zeros_like(xf)).to(x.dtype)
