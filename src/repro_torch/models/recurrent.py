"""Recurrent sequence mixing (port of ``src/repro/models/recurrent.py``).

``gated_linear_scan`` is the chunkwise gated linear recurrence of the
mLSTM cell (xlstm-350m),

    C_t = exp(lf_t) C_{t-1} + k_t v_t^T        (state (dk, dv))
    n_t = exp(lf_t) n_{t-1} + k_t              (normalizer)
    h_t = q_t C_t  [/ max(|q_t . n_t|, 1)]

run through the port's mLSTM scan kernel, and differentiable without a
final state (``return_state=False``): its gradient runs the mLSTM-scan
backward kernel; ``gated_linear_step`` is its
one-token decode in plain tensor ops (the reference computes it outside
any kernel too), and ``gated_linear_scan_ref`` the sequential oracle.

``slstm_scan`` is the stabilized sLSTM layer over the sLSTM cell kernel,
from the zero state or a given one, returning the final state;
``slstm_step`` is its one-token decode, the same kernel at S = 1;
``slstm_scan_stacked`` runs C clients' layers (leaves with a leading C
axis) in one kernel launch. Both scans are differentiable from the zero
state without a final state (``return_state=False``): the cell's
gradient runs the sLSTM backward kernel. The
reference's ``shard_axes`` (the batch sharded over a mesh inside the
time scan) is not ported: the port runs on one device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
from repro_torch.kernels.slstm_cell.ops import slstm_cell
from repro_torch.models.common import normal


def gated_linear_scan(q, k, v, log_f, *, chunk: int = 64, normalize: bool = True,
                      return_state: bool = False):
    """q, k (B, H, S, dk); v (B, H, S, dv); log_f (B, H, S) per-step log
    decay <= 0. Returns h (B, H, S, dv) in f32 (and the final (C, n) with
    ``return_state``), from the zero state."""
    return mlstm_scan(q, k, v, log_f, chunk=chunk, normalize=normalize,
                      return_state=return_state)


def gated_linear_step(q, k, v, log_f, state, *, normalize: bool = True):
    """Single-token decode. q, k (B, H, dk); v (B, H, dv); log_f (B, H);
    state = (C (B, H, dk, dv), n (B, H, dk)). Returns (h (B, H, dv),
    new_state)."""
    c, n = state
    decay = torch.exp(log_f.float())[..., None, None]
    c = decay * c + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    n = decay[..., 0] * n + k.float()
    h = torch.einsum("bhk,bhkv->bhv", q.float(), c)
    if normalize:
        denom = torch.clamp_min(torch.abs(torch.einsum(
            "bhk,bhk->bh", q.float(), n)), 1.0)
        h = h / denom[..., None]
    return h.to(v.dtype), (c, n)


def gated_linear_scan_ref(q, k, v, log_f, *, normalize: bool = True):
    """Sequential oracle, step by step from the zero state; h in v's dtype."""
    return mlstm_scan_ref(q, k, v, log_f, normalize=normalize).to(v.dtype)


# ------------------------------------------------------------------ sLSTM ----

def slstm_init(gen: torch.Generator, d: int, n_heads: int, dtype, *, device):
    """{wx (d, 4d) gate order z, i, f, o; r (H, hd, 4hd); b (4d,) zeros},
    scaled as the reference scales them."""
    hd = d // n_heads

    def draw(shape, scale):
        x = normal(gen, shape, device) * scale
        return x.to(device=device, dtype=dtype)

    return {
        "wx": draw((d, 4 * d), 1.0 / math.sqrt(d)),
        "r": draw((n_heads, hd, 4 * hd), 1.0 / math.sqrt(hd)),
        "b": torch.zeros((4 * d,), dtype=dtype, device=device),
    }


def slstm_scan(p, x, n_heads: int, initial_state=None,
               return_state: bool = True):
    """Stabilized sLSTM over time. x (B, S, d); initial_state (c, n, m,
    h), each (B, H, hd) f32, or None for the zero state. Returns
    (h (B, S, d) in f32, final state), heads in head-major order as the
    reference lays them out; the final state is None without
    ``return_state``."""
    b, s, d = x.shape
    hd = d // n_heads
    # pre-activations in f32, as the reference computes them before its scan
    pre_x = (x @ p["wx"].to(x.dtype) + p["b"].to(x.dtype)).float()
    pre_x = pre_x.reshape(b, s, 4, n_heads, hd).permute(0, 3, 1, 2, 4)
    hs = slstm_cell(pre_x.contiguous(), p["r"].float(), initial_state,
                    return_state=return_state)  # hs (B, H, S, hd)
    hs, final = hs if return_state else (hs, None)
    return hs.permute(0, 2, 1, 3).reshape(b, s, d), final


def slstm_scan_stacked(p, x, n_heads: int):
    """C clients' sLSTM layers on their own inputs, from the zero state,
    in one cell launch: leaves wx (C, d, 4d), r (C, H, hd, 4hd), b (C,
    4d); x (C, B, S, d). Returns h (C, B, S, d) in f32."""
    c, b, s, d = x.shape
    hd = d // n_heads
    pre_x = torch.bmm(x.reshape(c, b * s, d), p["wx"].to(x.dtype))
    pre_x = (pre_x + p["b"].to(x.dtype)[:, None, :]).float()
    pre_x = pre_x.reshape(c * b, s, 4, n_heads, hd).permute(0, 3, 1, 2, 4)
    hs = slstm_cell(pre_x.contiguous(), p["r"].float())  # (C*B, H, S, hd)
    return hs.permute(0, 2, 1, 3).reshape(c, b, s, d)


def slstm_step(p, x_t, n_heads: int, state):
    """Single-token sLSTM decode; x_t (B, d). Returns (h (B, d), state)."""
    h, final = slstm_scan(p, x_t[:, None, :], n_heads, initial_state=state)
    return h[:, 0], final
