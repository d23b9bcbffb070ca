"""Public wrapper: lossy wire round-trip of a batch of messages.

``wire_codec_roundtrip`` is the encode+decode hot path used by
``repro_torch.core.codec``. Per row it needs the symmetric int8 scale
(the largest |x|) and the magnitude top-k threshold (the k-th largest),
then one pass applying sparsify + quantize + dequantize. On the card the
CUDA kernels do all of it, the selection included
(``wire_codec.wire_codec_fused``): no library top-k and no host read.
On the CPU ``scale_thresh`` (a batched ``torch.topk``, as ``lax.top_k``
sits outside the Pallas kernel in the reference) feeds the plain
version; it is also the card's oracle, and ``scale_thresh`` +
``wire_codec_cuda`` (the library top-k, then the pass) is the yardstick
the fused kernels are timed beside.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wire_codec.ref import wire_codec_ref
from repro_torch.kernels.wire_codec.wire_codec import wire_codec_fused

# guards all-zero rows: q = x * 127/eps is still exactly 0 for x == 0
_EPS = 1e-30


def scale_thresh(x: torch.Tensor, k: int | None) -> torch.Tensor:
    """(L, 2) f32 per-row [scale, thresh] of x (L, N): scale is the
    largest |x| (at least 1e-30), thresh the k-th largest |x|, or 0 when
    the row is dense (k None or >= N) so that exact zeros are kept."""
    ax = x.float().abs()
    if k is not None and k < x.shape[1]:
        vals = torch.topk(ax, k, dim=1).values[:, [0, -1]]
        amax, thresh = vals[:, 0], vals[:, 1]
    else:
        amax = ax.amax(dim=1)
        thresh = torch.zeros_like(amax)
    return torch.stack([amax.clamp_min(_EPS), thresh], dim=1).contiguous()


def wire_codec_roundtrip(x: torch.Tensor, *, k: int | None = None,
                         quantize: bool = False) -> torch.Tensor:
    """x (L, N) float rows -> (L, N) decoded reconstruction.

    k: keep the k largest-|x| entries per row (None = dense); ties at
    the threshold magnitude are all kept. quantize: round-trip kept
    entries through per-row symmetric int8. k >= N with quantize=False
    is exactly the identity. A CUDA tensor goes through the CUDA
    kernels; only a CPU tensor takes the plain version.
    """
    if k is not None and k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if x.device.type == "cuda":
        return wire_codec_fused(x.contiguous(), k=k, quantize=quantize)[0]
    if x.device.type == "cpu":
        return wire_codec_ref(x, scale_thresh(x, k), quantize=quantize)
    raise ValueError(f"wire_codec_roundtrip runs on CUDA or the CPU, got {x.device}")
