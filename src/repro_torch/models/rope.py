"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (port of
``src/repro/models/rope.py``).

M-RoPE [arXiv:2409.12191] splits the head_dim/2 frequency slots into
(temporal, height, width) sections; text tokens use identical t=h=w
positions (reducing to 1-D RoPE), vision patches use their (t, h, w) grid
coordinates. Angles are computed in f32 on the positions' device.
"""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device)
                            / half))


def rope_angles(positions, head_dim: int, theta: float, sections=None):
    """positions: (..., S) int or (..., S, 3) for M-RoPE. Returns
    (..., S, head_dim/2) f32."""
    inv = _freqs(head_dim, theta, positions.device)  # (half,)
    if positions.dim() >= 2 and positions.shape[-1] == 3 and sections is not None:
        # M-RoPE: slot j uses its section's coordinate
        sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                       device=positions.device)
                            for i, s in enumerate(sections)])  # (half,)
        return positions[..., sec_id].float() * inv
    return positions[..., None].float() * inv


def apply_rope(x, angles):
    """x: (B, S, H, hd); angles: (B, S, hd/2) -> rotated x (rotate-half
    form), cos and sin cast to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def text_positions(batch: int, seq: int, *, device=None):
    """1-D positions (B, S) int32."""
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(
        batch, seq)


def mrope_positions(batch: int, n_vision: int, n_text: int, *, device=None):
    """(B, S, 3) int32 positions: vision patches on a grid of
    floor(sqrt(n_vision)) columns at t=0, then text from grid + 1 on
    (from 0 without patches)."""
    grid = max(int(n_vision ** 0.5), 1)
    idx = torch.arange(n_vision, dtype=torch.int32, device=device)
    vis = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid], dim=-1)
    t0 = (n_vision and (grid + 1)) or 0
    tpos = torch.arange(n_text, dtype=torch.int32, device=device) + t0
    txt = torch.stack([tpos, tpos, tpos], dim=-1)
    pos = torch.cat([vis, txt], dim=0)
    return pos[None].expand(batch, n_vision + n_text, 3)
