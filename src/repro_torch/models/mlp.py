"""Feed-forward blocks: SwiGLU / GELU / squared-ReLU (port of
``src/repro/models/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import activation, dense, dense_init


def mlp_init(gen, d: int, d_ff: int, act: str, dtype, *, device):
    p = {
        "up": dense_init(gen, d, d_ff, dtype, device=device),
        "down": dense_init(gen, d_ff, d, dtype, device=device),
    }
    if act == "swiglu":
        p["gate"] = dense_init(gen, d, d_ff, dtype, device=device)
    return p


def mlp(p, x, act: str):
    if act == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = activation(act)(dense(p["up"], x))
    return dense(p["down"], h)
