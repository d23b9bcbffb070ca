"""The mLSTM scan's gradient in the PyTorch port (``MLSTMScanFn`` through
``mlstm_scan`` / ``gated_linear_scan``, its CPU path: the plain forward,
then the plain step-by-step backward ``mlstm_scan_bwd_ref``) against
``jax.grad`` of the reference's chunkwise ``gated_linear_scan`` and of
its sequential kernel oracle (``repro.kernels.mlstm_scan.ref``), on the
same numpy inputs; the refusals of what the backward does not take; the
CUDA launcher's checks, which raise before anything is built.

Tolerance: ``mlstm_grad_error_bound``, row-relative like the forward's
``mlstm_error_bound``: 1e-5 plus 1e-4 of the row's largest |gradient|
(the last axis: dk or dv entries, and the S axis of dlog_f). The two
sides sum the same terms in other orders (the reference chunkwise, the
port step by step, carried over S steps); the largest gap seen here is
about 4e-5 of a row.

The kink of max(|q.n|, 1): ``jnp.maximum``'s derivative splits a tie,
``torch.clamp_min`` passes all of it to |q.n| (and ``torch.abs`` gives 0
at 0). The parity inputs keep |q.n| away from 1 (asserted);
``test_plain_backward_follows_torch_at_the_kink`` pins the port's side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan.ref import mlstm_scan_ref as jax_step_ref
from repro.models.recurrent import gated_linear_scan as jax_scan
from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as bwd_launcher
from repro_torch.kernels.mlstm_scan.ops import MLSTMScanFn, mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import (
    mlstm_grad_error_bound,
    mlstm_scan_bwd_ref,
    mlstm_scan_ref,
)
from repro_torch.models.recurrent import gated_linear_scan

from _torch_parity import one_torch_thread  # noqa: F401  (one torch thread)

# (b, h, s, dk, dv): two chunks of 64 and a ragged tail of 22 at dk = dv =
# 64; a small ragged case with dk != dv
SHAPES = [(1, 2, 150, 64, 64), (2, 3, 37, 16, 24)]


def _inputs(b, h, s, dk, dv, seed):
    """The reference kernel test's distributions, and an output weight
    (the loss is sum(h * w)), drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dk)).astype(np.float32)
    k = (rng.standard_normal((b, h, s, dk)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    lf = (-np.abs(rng.standard_normal((b, h, s))) * 0.2).astype(np.float32)
    w = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    return q, k, v, lf, w


def _qn_gap(q, k, lf):
    """min over steps of ||q_t . n_t| - 1|: how far the inputs stay from
    the normalizer's kink."""
    gaps = []
    n = np.zeros(q.shape[:2] + q.shape[3:], np.float64)
    for t in range(q.shape[2]):
        n = np.exp(lf[:, :, t])[..., None] * n + k[:, :, t]
        gaps.append(np.abs(np.abs((q[:, :, t] * n).sum(-1)) - 1.0).min())
    return min(gaps)


def _assert_within(got, want):
    for name, g, w in zip(("dq", "dk", "dv", "dlog_f"), got, want):
        w = torch.from_numpy(np.array(w))
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32, name
        err = (g - w).abs()
        bound = mlstm_grad_error_bound(w)
        assert bool((err <= bound).all()), (name, float((err / bound).max()))


@pytest.mark.parametrize("b,h,s,dk,dv", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("reference", ["gated_linear_scan", "step_ref"])
def test_plain_backward_matches_jax_grad(b, h, s, dk, dv, normalize, reference):
    q, k, v, lf, w = _inputs(b, h, s, dk, dv, seed=s + dk + dv)
    if normalize:
        assert _qn_gap(q, k, lf) > 1e-4

    def loss(*x):
        if reference == "gated_linear_scan":
            out = jax_scan(*x, chunk=64, normalize=normalize)
        else:
            out = jax_step_ref(*x, normalize=normalize)
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, lf)))
    got = mlstm_scan_bwd_ref(*map(torch.from_numpy, (q, k, v, lf)),
                             torch.from_numpy(w), normalize=normalize)
    _assert_within(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_autograd_cpu_path_is_the_plain_backward(normalize):
    """``mlstm_scan`` and ``gated_linear_scan`` with inputs that require
    grad go through ``MLSTMScanFn``: the output has a grad_fn, equals the
    no-grad output, and its gradient is ``mlstm_scan_bwd_ref``'s bit for
    bit."""
    q, k, v, lf, w = _inputs(2, 2, 70, 16, 8, seed=5)
    plain = mlstm_scan(*map(torch.from_numpy, (q, k, v, lf)), normalize=normalize)
    want = mlstm_scan_bwd_ref(*map(torch.from_numpy, (q, k, v, lf)),
                              torch.from_numpy(w), normalize=normalize)
    for fn in (mlstm_scan, gated_linear_scan):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, lf)]
        out = fn(*xs, normalize=normalize)
        assert out.grad_fn is not None and "MLSTMScanFn" in type(out.grad_fn).__name__
        assert torch.equal(out.detach(), plain)
        (out * torch.from_numpy(w)).sum().backward()
        for x, g in zip(xs, want):
            assert torch.equal(x.grad, g)


def test_gradient_of_some_inputs_only():
    """A gradient for v alone (q, k, log_f constants) is the full
    backward's dv."""
    q, k, v, lf, w = _inputs(1, 2, 40, 8, 8, seed=9)
    tv = torch.from_numpy(v).requires_grad_()
    out = mlstm_scan(*map(torch.from_numpy, (q, k)), tv, torch.from_numpy(lf))
    (dv,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [tv])
    want = mlstm_scan_bwd_ref(*map(torch.from_numpy, (q, k, v, lf)),
                              torch.from_numpy(w))[2]
    assert torch.equal(dv, want)


def test_plain_backward_follows_torch_at_the_kink():
    """At |q.n| = 1 exactly (dk = 1, q = k = 1 at step 0) and at q.n = 0,
    the plain backward equals torch autograd of the plain forward:
    clamp_min's and abs's derivatives, not jnp.maximum's split."""
    q = torch.tensor([[[[1.0], [0.0], [2.0]]]])
    k = torch.tensor([[[[1.0], [0.5], [0.25]]]])
    v = torch.tensor([[[[0.3, -1.2], [0.7, 0.1], [-0.4, 0.9]]]])
    lf = torch.tensor([[[0.0, -0.1, -0.2]]])
    w = torch.tensor([[[[1.0, 2.0], [-1.0, 0.5], [0.25, -3.0]]]])
    xs = [x.clone().requires_grad_() for x in (q, k, v, lf)]
    (mlstm_scan_ref(*xs) * w).sum().backward()
    got = mlstm_scan_bwd_ref(q, k, v, lf, w)
    for x, g in zip(xs, got):
        torch.testing.assert_close(g, x.grad, rtol=1e-6, atol=1e-6)


def test_refusals_name_item_15b():
    """What the backward does not take refuses at the call, on every
    device: a final state with a gradient (ROADMAP item 15c-2), and an
    input neither f32 nor bf16 (a double). bf16 inputs train since item
    15c-1: cast up to f32 before ``MLSTMScanFn``, their gradients come
    back in bf16, the f32 gradients of the inputs cast up, cast down.
    Without a gradient the refused calls run as before."""
    q, k, v, lf, _ = _inputs(1, 1, 8, 4, 4, seed=1)
    xs = [torch.from_numpy(x) for x in (q, k, v, lf)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 15c-2"):
        mlstm_scan(xs[0].requires_grad_(), *xs[1:], return_state=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 15c"):
        gated_linear_scan(*[x.double().requires_grad_() for x in xs])
    bf = [x.detach().bfloat16().requires_grad_() for x in xs[:3]] + [xs[3].detach()]
    out = gated_linear_scan(*bf)
    assert "MLSTMScanFn" in type(out.grad_fn).__name__ and out.dtype == torch.float32
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad(out, bf[:3], w)
    up = [x.detach().float().requires_grad_() for x in bf[:3]]
    want = torch.autograd.grad(gated_linear_scan(*up, xs[3].detach()), up, w)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, h.bfloat16())
               for g, h in zip(got, want))
    with torch.no_grad():
        out, (c, n) = mlstm_scan(*xs, return_state=True)
    assert out.grad_fn is None and tuple(c.shape) == (1, 1, 4, 4)
    out, _ = mlstm_scan(*[x.detach() for x in xs], return_state=True)
    assert out.grad_fn is None


def test_bwd_launcher_checks_before_building(monkeypatch):
    """The CUDA launcher raises on CPU tensors, other dtypes, mismatched
    shapes and grids past an int, before it builds or launches anything;
    its Python mirror of a chunk CTA's shared memory, the launches a call
    and the scratch."""
    def no_build(*a, **k):
        raise AssertionError("the launcher built its library")

    monkeypatch.setattr(bwd_launcher._build, "load", no_build)
    q, k, v, lf, w = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 4, 6, seed=2))
    before = bwd_launcher.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd_launcher.mlstm_scan_bwd_cuda(q, k, v, lf, w, w)
    with pytest.raises(ValueError, match="float32"):
        bwd_launcher.mlstm_scan_bwd_cuda(q.double(), k, v, lf, w, w)
    with pytest.raises(ValueError, match="want k"):
        bwd_launcher.mlstm_scan_bwd_cuda(q, k[:, :1], v, lf, w, w)
    # dk 1025 with the normalizer and dv 800, which the SIMT design
    # refused (its prep kernel's registers, its scan CTA's shared memory),
    # pass every check but the device's
    with pytest.raises(ValueError, match="CUDA tensors"):
        big = torch.zeros(1, 1, 2, 1025)
        bwd_launcher.mlstm_scan_bwd_cuda(big, big, v[:, :1, :2], lf[:, :1, :2],
                                         w[:, :1, :2], w[:, :1, :2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        wide = torch.zeros(1, 1, 2, 800)
        bwd_launcher.mlstm_scan_bwd_cuda(q[:, :1, :2], k[:, :1, :2], wide,
                                         lf[:, :1, :2], wide, wide)
    with pytest.raises(ValueError, match="grid"):  # 2^21 (b, h) x 2^16 chunks
        qm = torch.empty(2**21, 1, 2**22, 1, device="meta")
        lm = torch.empty(2**21, 1, 2**22, device="meta")
        bwd_launcher.mlstm_scan_bwd_cuda(qm, qm, qm, lm, qm, qm)
    assert bwd_launcher.launches == before
    # one chunk CTA's shared memory at every shape: a ring of two stages
    # of two (64, 32) slices at stride 36, five (64, 64) tiles at stride
    # 72, seven rows of per-step values; five launches a call, with or
    # without the normalizer; the scratch at xlstm-350m's training shape (32 (b, h)
    # pairs, S 128, dk = dv = 512, the normalizer column) and hymba's Mamba
    # heads (50 pairs, S 2048, dk 16, dv 64)
    assert bwd_launcher.CHUNK_SMEM == 4 * (2 * 2 * 64 * 36 + 5 * 64 * 72 + 7 * 64) == 130816
    assert bwd_launcher.LAUNCHES == 5
    assert bwd_launcher.work_bytes(32, 128, 512, 512, True) == 4 * (
        32 * 128 * 512 + 32 * 128 + 2 * 32 * 512 * 516 + 32 * 2 * 2 * 4096
        + 32 * 8 * 128 + 2 * 32 * 8 * 9)
    assert bwd_launcher.work_bytes(50, 2048, 16, 64, False) == 4 * (
        2 * 50 * 31 * 16 * 64 + 50 * 32 * 2 * 4096 + 50 * 2048 + 2 * 50 * 1 * 1)


def test_autograd_fn_saves_the_forward_output():
    """The saved output is the forward's own (the CUDA backward reads h
    for the normalize step)."""
    q, k, v, lf, _ = _inputs(1, 1, 12, 4, 4, seed=3)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, lf)]
    out = MLSTMScanFn.apply(*xs, 64, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[4], out.detach())


def test_plain_backward_reads_the_given_h():
    """The normalize step's backward reads the forward's output where it
    is given: its own output gives the same bits as none, and another h
    (the same values moved by 1e-5 of their row at random) moves dq past
    its bound (dq is a difference of two large terms)."""
    q, k, v, lf, w = (torch.from_numpy(x) for x in _inputs(1, 2, 128, 512, 512, seed=4))
    out = mlstm_scan_ref(q, k, v, lf)
    base = mlstm_scan_bwd_ref(q, k, v, lf, w)
    same = mlstm_scan_bwd_ref(q, k, v, lf, w, h=out)
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(out.shape)).astype(np.float32))
    moved = out + 1e-5 * out.abs().amax(-1, keepdim=True) * noise
    dq = mlstm_scan_bwd_ref(q, k, v, lf, w, h=moved)[0]
    err = (dq - base[0]).abs()
    assert float((err / mlstm_grad_error_bound(base[0])).max()) > 1


@pytest.mark.parametrize("normalize", [True, False])
def test_dq_scale_is_the_summands_size(normalize):
    """``dq_scale``: the gradients are the same bits, and the scale (the
    row's largest |C du| + |n ds|) is at least each dq row's largest
    |entry|, many times it where the two cancel (without the normalizer,
    equal to it: ds = 0)."""
    q, k, v, lf, w = (torch.from_numpy(x) for x in _inputs(2, 2, 80, 16, 8, seed=6))
    base = mlstm_scan_bwd_ref(q, k, v, lf, w, normalize=normalize)
    got, scale = mlstm_scan_bwd_ref(q, k, v, lf, w, normalize=normalize,
                                    dq_scale=True)
    assert all(torch.equal(a, b) for a, b in zip(base, got))
    assert tuple(scale.shape) == (2, 2, 80, 1)
    row = got[0].abs().amax(-1, keepdim=True)
    if normalize:
        assert bool((scale >= row).all())
        assert float((scale / row.clamp_min(1e-30)).max()) > 10  # cancellation
    else:
        assert torch.equal(scale, row)
    bound = mlstm_grad_error_bound(got[0], scale)
    assert torch.equal(bound, (1e-5 + 1e-4 * scale).expand_as(got[0]))
