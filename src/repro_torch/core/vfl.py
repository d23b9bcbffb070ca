"""Vertical (split) training for fragmented data — paper Alg. 1 lines 9-23
(port of ``src/repro/core/vfl.py``).

The exchange is SplitNN-shaped:

    client k:  h_m = f_m(x_m)                     ClientForwardPass
    server:    align h_A, h_B by global sample id ServerAggregateFeatures
               ŷ = g_M^v(h_A, h_B); L(ŷ, y)       ServerForwardPass
               ∂L/∂g_M^v, ∂L/∂h_A, ∂L/∂h_B        ServerBackwardPass
    client k:  ∂L/∂f_m = vjp(f_m, x_m)(∂L/∂h_m)   ReceiveGradients+Backward

Raw data never leaves a client — only latent features go up and feature
cotangents come down. The client backward is the exact vjp of the client
forward (``torch.autograd.grad`` with ``grad_outputs`` the cotangent), so
the split gradients equal autodiff of the joint model
(tests/test_torch_vfl.py).

The federation's phase 2 runs the same exchange as one joint
forward/backward over stacked clients (``core/engine.py::vfl_step``);
these helpers serve the baselines (``core/baselines.py``). The
reference's whole-step ``vfl_step`` / ``vfl_step_split`` serve only its
tests and are not ported: the port's tests compose the same step from
these helpers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.core.engine import value_and_grad
from repro_torch.core.encoders import EncoderConfig, encoder_apply, fusion_apply, task_loss


# --------------------------------------------------------------- alignment --

def align_by_id(ids_a: np.ndarray, ids_b: np.ndarray):
    """Server-side private-set alignment: row indices (ia, ib) such that
    ids_a[ia] == ids_b[ib], each id used once, sorted by id."""
    common, ia, ib = np.intersect1d(ids_a, ids_b, return_indices=True)
    return common, ia, ib


# ------------------------------------------------------------ split passes --

def client_forward(f_params, x, ecfg: EncoderConfig):
    """ClientForwardPass: latent features h for local fragmented samples."""
    return encoder_apply(f_params, x, ecfg)


def server_loss(gmv_params, h_a, h_b, y, kind: str):
    logits = fusion_apply(gmv_params, h_a, h_b)
    return task_loss(logits, y, kind)


def server_forward_backward(gmv_params, h_a, h_b, y, kind: str):
    """ServerForward+BackwardPass: loss, server-head grads, feature grads."""
    def loss_fn(p):
        loss = server_loss(*p, y, kind)
        return loss, loss

    loss, (g_srv, g_ha, g_hb) = value_and_grad(loss_fn, (gmv_params, h_a, h_b))
    return loss, g_srv, g_ha, g_hb


def client_backward(f_params, x, h_grad, ecfg: EncoderConfig):
    """ReceiveGradientsAndBackwardPass: chain the feature cotangent through
    the local encoder. Exact vjp -> split grads == joint autodiff."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(f_params)]
    with torch.enable_grad():
        h = encoder_apply(tree_unflatten(f_params, leaves), x, ecfg)
        grads = torch.autograd.grad(h, leaves, grad_outputs=h_grad)
    return tree_unflatten(f_params, grads)


# ------------------------------------------------------- one VFL iteration --

@dataclasses.dataclass
class VflBatch:
    """Aligned fragmented batch: rows of x_a / x_b refer to the same global
    samples; owner_a[i] / owner_b[i] are the holding clients' indices."""

    x_a: np.ndarray
    x_b: np.ndarray
    y: np.ndarray
    owner_a: np.ndarray
    owner_b: np.ndarray


def build_vfl_batches(clients, batch_size: int, rng: np.random.Generator):
    """Server-side alignment of all fragmented rows (Private Set
    Intersection stand-in, per the paper's assumption)."""
    xa, ia, oa = [], [], []
    xb, ib, ob = [], [], []
    for k, c in enumerate(clients):
        if len(c.frag_a):
            xa.append(c.frag_a.x); ia.append(c.frag_a.ids)
            oa.append(np.full(len(c.frag_a), k))
        if len(c.frag_b):
            xb.append(c.frag_b.x); ib.append(c.frag_b.ids)
            ob.append(np.full(len(c.frag_b), k))
    if not xa or not xb:
        return []
    xa = np.concatenate(xa); ia = np.concatenate(ia); oa = np.concatenate(oa)
    xb = np.concatenate(xb); ib = np.concatenate(ib); ob = np.concatenate(ob)
    _, ra, rb = align_by_id(ia, ib)
    if len(ra) == 0:
        return []
    ya = np.concatenate([c.frag_a.y for c in clients if len(c.frag_a)])
    order = rng.permutation(len(ra))
    ra, rb = ra[order], rb[order]
    batches = []
    for i in range(0, len(ra), batch_size):
        sa, sb = ra[i : i + batch_size], rb[i : i + batch_size]
        batches.append(VflBatch(xa[sa], xb[sb], ya[sa], oa[sa], ob[sb]))
    return batches

