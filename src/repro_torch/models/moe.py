"""Mixture-of-Experts layer (port of ``src/repro/models/moe.py``): top-k
routing with fixed expert capacity and scatter/gather dispatch (no
(T, E, C) one-hot blowup), plus always-on shared experts (DeepSeek-MoE
fine-grained style) and a Switch-style load-balance auxiliary loss.

Two dispatch paths, as in the reference, picked by ``moe_apply``:

- flat: one scatter of every (token, k) assignment into its expert's
  queue (token-major queue positions; an assignment past the capacity
  goes to the spill slot ``e * cap`` and is dropped), the experts' MLPs
  as batched products over (E, cap, d), and one gather back;
- grouped (``cfg.moe_groups`` = G > 0, GShard-style): the tokens cut
  into G groups of T / G, each with its own capacity and its own
  token-major queues; the (G, E, capg, d) buffers move to the experts'
  (E, G * capg, d) layout, and back after the experts.

The reference runs the grouped path one group a data shard and pins
its layouts to the mesh (``_wsc``); on one device there is no mesh, so
the port keeps the arithmetic and the layout moves and nothing else.
The reference computes all of it outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, dense_init, normal
from repro_torch.models.mlp import mlp, mlp_init


def moe_init(gen, cfg, dtype, *, device):
    """Router (d, E), the E experts' MLPs with every leaf stacked on a
    leading E axis (the layout of the reference's vmap init, drawn into
    one tensor a leaf), and the shared experts fused into one MLP."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def stacked(d_in, d_out):
        w = normal(gen, (e, d_in, d_out), device)
        return {"w": w.mul_(1.0 / math.sqrt(d_in)).to(device=device, dtype=dtype)}

    experts = {"up": stacked(d, ff), "down": stacked(ff, d)}
    if cfg.act == "swiglu":
        experts["gate"] = stacked(d, ff)
    p = {"router": dense_init(gen, d, e, dtype, device=device), "experts": experts}
    if cfg.n_shared_experts:
        # n_shared separate MLPs summed equal one MLP n_shared times wider
        p["shared"] = mlp_init(gen, d, ff * cfg.n_shared_experts, cfg.act, dtype,
                               device=device)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / max(cfg.n_experts, 1))
    return max(c, cfg.top_k)


def _route(p, cfg, xf):
    """xf (T, d) -> (gate_vals (T, k), expert_idx (T, k), probs (T, E)):
    the top-k gates renormalized over the k picked."""
    logits = (xf @ p["router"]["w"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    return gate_vals, expert_idx, probs


def _one_hot(idx, e: int):
    return idx[..., None] == torch.arange(e, device=idx.device)


def _aux_loss(cfg, probs, expert_idx):
    """Switch load-balance loss over the full token set."""
    e, k = cfg.n_experts, cfg.top_k
    me = _one_hot(expert_idx.reshape(-1, k), e).float().sum(1).mean(0)
    ce = probs.reshape(-1, e).mean(0)
    return e * torch.sum(me / k * ce)


def _dispatch_indices(expert_idx, e: int, cap: int, groups: int = 0):
    """expert_idx (T, k) -> (slot (T*k,), keep (T*k,)): position of each
    (token, k) assignment within its expert queue, token-major; overflow
    -> slot e * cap. With ``groups`` G > 0 the T tokens are G groups of
    T / G, each with queues of its own: slot and keep are (G, T/G * k)."""
    flat_expert = expert_idx.reshape(groups, -1) if groups else expert_idx.reshape(-1)
    onehot = _one_hot(flat_expert, e).long()
    pos = ((torch.cumsum(onehot, dim=-2) - onehot) * onehot).sum(-1)
    keep = pos < cap
    slot = torch.where(keep, flat_expert * cap + pos,
                       torch.full_like(pos, e * cap))
    return slot, keep


def _experts_apply(ep, xe, act: str):
    """The E experts' MLPs on their queues: xe (E, cap, d) -> (E, cap, d)."""
    def bdense(p, x):
        return torch.bmm(x, p["w"].to(x.dtype))

    if act == "swiglu":
        h = F.silu(bdense(ep["gate"], xe)) * bdense(ep["up"], xe)
    else:
        h = activation(act)(bdense(ep["up"], xe))
    return bdense(ep["down"], h)


def _moe_flat(p, cfg, x):
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    cap = _capacity(t, cfg)
    e, k = cfg.n_experts, cfg.top_k

    gate_vals, expert_idx, probs = _route(p, cfg, xf)
    slot, keep = _dispatch_indices(expert_idx, e, cap)

    # every kept slot receives exactly one row; only the spill slot sums
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, xf.repeat_interleave(k, dim=0))  # token-major
    out_buf = _experts_apply(p["experts"], buf[: e * cap].reshape(e, cap, d),
                             cfg.act)

    flat_out = torch.cat([out_buf.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=xf.dtype, device=xf.device)])
    routed = flat_out[slot] * (gate_vals.reshape(-1, 1) * keep[:, None]).to(xf.dtype)
    out = routed.reshape(t, k, d).sum(dim=1)
    if "shared" in p:
        out = out + mlp(p["shared"], xf, cfg.act)
    return out.reshape(b, s, d), _aux_loss(cfg, probs, expert_idx)


def _moe_grouped(p, cfg, x):
    """GShard-style grouped dispatch over ``cfg.moe_groups`` groups."""
    b, s, d = x.shape
    t = b * s
    g = cfg.moe_groups
    tg = t // g
    e, k = cfg.n_experts, cfg.top_k
    capg = _capacity(tg, cfg)

    xg = x.reshape(g, tg, d)
    gate_vals, expert_idx, probs = _route(p, cfg, xg)  # (G, tg, k)
    slot, keep = _dispatch_indices(expert_idx.reshape(g * tg, k), e, capg,
                                   groups=g)  # (G, tg * k)

    # each group's queues, with its own spill slot e * capg
    buf = torch.zeros((g, e * capg + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot[..., None].expand(g, tg * k, d),
                     xg.repeat_interleave(k, dim=1))
    # groups -> experts: (G, E, capg, d) -> (E, G * capg, d)
    ex_in = buf[:, : e * capg].reshape(g, e, capg, d).transpose(0, 1)
    out_buf = _experts_apply(p["experts"], ex_in.reshape(e, g * capg, d), cfg.act)
    back = out_buf.reshape(e, g, capg, d).transpose(0, 1).reshape(g, e * capg, d)

    back = torch.cat([back, torch.zeros((g, 1, d), dtype=x.dtype,
                                        device=x.device)], dim=1)
    routed = torch.gather(back, 1, slot[..., None].expand(g, tg * k, d))
    routed = routed * (gate_vals.reshape(g, tg * k, 1)
                       * keep[..., None]).to(x.dtype)
    out = routed.reshape(g, tg, k, d).sum(dim=2).reshape(b, s, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x.reshape(t, d), cfg.act).reshape(b, s, d)
    return out, _aux_loss(cfg, probs, expert_idx)


def uses_groups(cfg, n_tokens: int) -> bool:
    """Whether ``moe_apply`` takes the grouped path for ``n_tokens``
    tokens: G > 0 groups that cut them evenly, each of at least top_k."""
    g = cfg.moe_groups
    return bool(g) and n_tokens % g == 0 and n_tokens // g >= cfg.top_k


def moe_apply(p, cfg, x):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    if uses_groups(cfg, x.shape[0] * x.shape[1]):
        return _moe_grouped(p, cfg, x)
    return _moe_flat(p, cfg, x)
