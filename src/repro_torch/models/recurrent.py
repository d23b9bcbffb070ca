"""The sLSTM layer (port of the sLSTM part of
``src/repro/models/recurrent.py``), run through the port's sLSTM cell
kernel.

The reference's ``slstm_scan`` also takes an ``initial_state`` and
returns the final state, and can shard its batch (``shard_axes``);
those serve only the language model's one-token decode (``slstm_step``)
and the SPMD round, and come with the language-model substrate. Here
the recurrence always starts from the zero state and only the sequence
of outputs is returned.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.slstm_cell.ops import slstm_cell


def slstm_init(gen: torch.Generator, d: int, n_heads: int, dtype, *, device):
    """{wx (d, 4d) gate order z, i, f, o; r (H, hd, 4hd); b (4d,) zeros},
    scaled as the reference scales them."""
    hd = d // n_heads

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=gen.device) * scale
        return x.to(device=device, dtype=dtype)

    return {
        "wx": normal((d, 4 * d), 1.0 / math.sqrt(d)),
        "r": normal((n_heads, hd, 4 * hd), 1.0 / math.sqrt(hd)),
        "b": torch.zeros((4 * d,), dtype=dtype, device=device),
    }


def slstm_scan(p, x, n_heads: int):
    """Stabilized sLSTM over time from the zero state. x (B, S, d) ->
    h (B, S, d) in f32, heads in head-major order as the reference
    lays them out."""
    b, s, d = x.shape
    hd = d // n_heads
    # pre-activations in f32, as the reference computes them before its scan
    pre_x = (x @ p["wx"].to(x.dtype) + p["b"].to(x.dtype)).float()
    pre_x = pre_x.reshape(b, s, 4, n_heads, hd).permute(0, 3, 1, 2, 4)
    hs = slstm_cell(pre_x.contiguous(), p["r"].float())  # (B, H, S, hd)
    return hs.permute(0, 2, 1, 3).reshape(b, s, d)
