"""Shared CPU parity checks of the port's training at the reference's
production numerics (``launch/specs.py``: bf16 compute, f32 parameters,
``remat``; ROADMAP item 15c-1) against the JAX reference
(``tests/test_torch_lm_train_bf16*.py``).

``reference(name)`` builds a family at ``reduced()`` (2 layers) with
``compute_dtype="bfloat16", remat=True`` on both sides, the reference's
init carried across with ``params_from_numpy``, a batch from the
reference CLI's ``build_batch``, then ``jax.value_and_grad`` of the
reference's ``loss_fn`` and its ``adamw`` step on it. A MoE family's
router choices are recorded in that run (a ``jax.debug.callback`` in
``_route``: each layer's forward, then its rematerialized forward in the
backward) and replayed on the port's side (``chip_smoke.moe_forced``:
the port keeps its own router probabilities; in bf16 a token's k-th and
(k+1)-th expert can sit within the two runs' rounding of each other).

Tolerance: ``chip_smoke.bf16_share``'s bound, sqrt(r) 2^-7 of a row's
norm after r bf16 roundings upstream: the loss at the forward's
roundings (``bf16_roundings``), each gradient leaf (as one row) at
``chip_smoke.grad_roundings`` (the forward's, then as many on the way
back). After the AdamW step: the first moment (0.1 g) and sqrt of the
second (sqrt(0.001) |g|) at the gradients' bound; each parameter's
change equal, to f32 rounding (``STEP_SLACK``), to the reference's
``adamw`` update of the port's own gradients (which the gradient check
holds to the reference's), so the update formula itself is held: its
sign, eps and weight decay; and the parameters within
``chip_smoke.ADAM_STEP_BOUND`` times the learning rate of the
reference's (a first step moves each entry by at most lr (|m^| /
sqrt(v^) <= 1) plus the same weight decay on both sides). The bounds'
controls: with the first call of the attention's backward zeroed, a
gradient falls outside its bound; with the update's sign flipped, a
parameter's change falls outside its.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import repro.models.moe as jmoe  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch.train import build_batch  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.common.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

from _torch_lm_train_parity import leaves  # noqa: E402

BATCH, SEQ = 4, 48
LR = 1e-3
# a parameter's change against the reference's update of the same
# gradient: one f32 rounding of p + u (the spacing of p1) and 2^-18 of
# |u| (sqrt, divisions and sums in f32 on two compilers)
STEP_SLACK = 2.0 ** -18


def configs(name: str, **extra):
    """(reference config, port config): ``reduced()`` at the production
    numerics."""
    kw = dict(compute_dtype="bfloat16", remat=True, **extra)
    return jget(name).reduced().replace(**kw), get_config(name).reduced().replace(**kw)


@contextlib.contextmanager
def recorded_routes(on: bool):
    """Within the block, every call of the reference's ``_route`` appends
    its expert choices (numpy, in the order the computation runs them)
    to the yielded list."""
    routes, orig = [], jmoe._route

    def rec(p, cfg, xf):
        gates, idx, probs = orig(p, cfg, xf)
        jax.debug.callback(lambda i: routes.append(np.array(i)), idx)
        return gates, idx, probs

    if on:
        jmoe._route = rec
    try:
        yield routes
    finally:
        jmoe._route = orig


def reference(name: str, **extra) -> dict:
    """The reference's bf16 ``loss_fn`` value and gradients and one AdamW
    step (lr LR) from its init, on one batch of BATCH x SEQ tokens."""
    jc, tc = configs(name, **extra)
    jp = jbb.init_params(jax.random.PRNGKey(0), jc)
    batch = build_batch(jc, BATCH, SEQ, np.random.default_rng(0))
    with recorded_routes(jc.n_experts > 0) as routes:
        (total, metrics), grads = jax.value_and_grad(jbb.loss_fn, has_aux=True)(
            jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = jopt.adamw(LR)
    updates, state = opt.update(grads, opt.init(jp), jp)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(jc=jc, tc=tc, p0=np_tree(jp), tp=params_from_numpy(np_tree(jp), "cpu"),
                batch=batch, routes=list(routes), total=float(total),
                loss=float(metrics["loss"]), grads=np_tree(grads),
                params=np_tree(jopt.apply_updates(jp, updates)),
                mu=np_tree(state["mu"]), nu=np_tree(state["nu"]))


def _tb(ref):
    return {k: torch.from_numpy(v) for k, v in ref["batch"].items()}


def _replayed(ref):
    """The reference's router choices replayed on the port (MoE only)."""
    if not ref["routes"]:
        return contextlib.nullcontext({"differ": 0})
    return chip_smoke.moe_forced([(None, torch.from_numpy(r), None)
                                  for r in ref["routes"]])


def leaf_shares(want, got, roundings: int) -> dict:
    """{path: ``bf16_share`` of each leaf as one row}."""
    pairs = list(zip(leaves(want), leaves(got), strict=True))
    assert all(p == q for (p, _), (q, _) in pairs)
    return {p: chip_smoke.bf16_share(g, w, roundings, row_axes=max(w.ndim, 1))
            for (p, w), (_, g) in pairs}


def port_gradients(ref) -> tuple:
    """(total, gradients as numpy) of the port's ``loss_fn`` at the
    reference's init, the reference's router choices replayed."""
    with _replayed(ref):
        total, _, grads = tbb._value_and_grad(ref["tp"], ref["tc"], _tb(ref))
    return float(total), params_to_numpy(grads)


def check_loss_and_gradients(ref) -> float:
    """The loss within the forward's bound, every gradient leaf within
    ``grad_roundings``' bound; returns the largest gradient share."""
    tc = ref["tc"]
    if ref["routes"]:  # forward, then the backward's recomputation reversed
        routes, n = ref["routes"], tc.n_layers
        assert len(routes) == 2 * n and all(
            np.array_equal(routes[i], routes[2 * n - 1 - i]) for i in range(n))
    total, grads = port_gradients(ref)
    loss_share = chip_smoke.bf16_share(np.array([total]), np.array([ref["total"]]),
                                       chip_smoke.bf16_roundings(tc))
    assert loss_share <= 1.0, (total, ref["total"], loss_share)
    shares = leaf_shares(ref["grads"], grads, chip_smoke.grad_roundings(tc))
    worst = max(shares, key=shares.get)
    assert shares[worst] <= 1.0, (worst, shares[worst])
    return shares[worst]


def port_step(ref, opt=None) -> tuple:
    """(parameters, state) after one train step of the production entry's
    kind (``make_train_step``, AdamW at LR unless ``opt`` is given) from
    a copy of the reference's init."""
    params = tree_map(torch.clone, ref["tp"])  # a copy: the step owns it
    opt = topt.adamw(LR) if opt is None else opt
    with _replayed(ref):
        params, state, _ = tbb.make_train_step(ref["tc"], opt)(
            params, opt.init(params), _tb(ref))
    return params, state


def step_share(ref, params) -> float:
    """The largest share, over the entries, of |p1 - p0 - u| in the bound
    spacing(p0 + u) + STEP_SLACK |u|, where u is the reference's
    ``adamw(LR)`` first update of the port's own gradients
    (``port_gradients``: the gradients the step computes)."""
    _, grads = port_gradients(ref)
    jo = jopt.adamw(LR)
    p0 = jax.tree.map(jnp.asarray, ref["p0"])
    u, _ = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(p0), p0)
    want = jax.tree.map(np.asarray, jopt.apply_updates(p0, u))
    worst = 0.0
    for (path, w), (_, g), (_, du) in zip(
            leaves(want), leaves(params_to_numpy(params)),
            leaves(jax.tree.map(np.asarray, u)), strict=True):
        if not np.isfinite(g).all():
            return float("inf")
        bound = np.spacing(np.abs(w)) + STEP_SLACK * np.abs(du)
        worst = max(worst, float((np.abs(g - w) / bound).max()))
    return worst


def check_adamw_step(ref) -> None:
    """One step of the production entry's kind (``port_step``) against
    the reference's step: the moments at the gradients' bound, each
    parameter's change the reference's update of the port's gradients
    (``step_share``), the parameters within ADAM_STEP_BOUND x LR of the
    reference's."""
    params, state = port_step(ref)
    assert int(state["step"]) == 1
    r = chip_smoke.grad_roundings(ref["tc"])
    for key, want, got in (("mu", ref["mu"], params_to_numpy(state["mu"])),
                           ("sqrt nu", jax.tree.map(np.sqrt, ref["nu"]),
                            jax.tree.map(np.sqrt, params_to_numpy(state["nu"])))):
        shares = leaf_shares(want, got, r)
        assert max(shares.values()) <= 1.0, (key, max(shares.items(), key=lambda x: x[1]))
    share = step_share(ref, params)
    assert share <= 1.0, share
    for (path, w), (_, g) in zip(leaves(ref["params"]), leaves(params_to_numpy(params)),
                                 strict=True):
        assert np.abs(g - w).max() <= chip_smoke.ADAM_STEP_BOUND * LR, path


def flipped_step_share(ref) -> float:
    """``step_share`` of a step whose AdamW update has its sign flipped
    (must exceed 1)."""
    opt = topt.adamw(LR)

    def update_(grads, state, params):
        updates, state = opt.update_(grads, state, params)
        for u in tree_leaves(updates):
            u.neg_()
        return updates, state

    params, _ = port_step(ref, dataclasses.replace(opt, update_=update_))
    return step_share(ref, params)


@contextlib.contextmanager
def zeroed_first_backward():
    """Within the block, the first call of the attention's backward (its
    CPU path, the plain backward) returns zeros."""
    orig, calls = fops.flash_attention_bwd_ref, []

    def wrong(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(1)
        return tuple(torch.zeros_like(x) for x in out) if len(calls) == 1 else out

    fops.flash_attention_bwd_ref = wrong
    try:
        yield calls
    finally:
        fops.flash_attention_bwd_ref = orig


def control_share(ref) -> float:
    """The largest gradient share with the first attention backward
    zeroed (must exceed 1)."""
    with zeroed_first_backward() as calls:
        _, grads = port_gradients(ref)
    assert calls
    return max(leaf_shares(ref["grads"], grads,
                           chip_smoke.grad_roundings(ref["tc"])).values())


def check_remat_bit_for_bit(ref) -> None:
    """The port's loss, gradients and in-place AdamW step with ``remat``
    equal those without it bit for bit on the CPU (the same operations
    on the same inputs: the recomputed forward gives the bits the first
    one gave)."""
    out = []
    for remat in (True, False):
        tc = ref["tc"].replace(remat=remat)
        with _replayed(ref):  # without remat: the first forward's choices
            total, _, grads = tbb._value_and_grad(ref["tp"], tc, _tb(ref))
        params = tree_map(torch.clone, ref["tp"])
        opt = topt.adamw(LR)
        with _replayed(ref):
            params, state, metrics = tbb.make_train_step(tc, opt)(
                params, opt.init(params), _tb(ref))
        out.append([total, metrics["loss"]] + tree_leaves(grads)
                   + tree_leaves(params) + tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*out, strict=True))
