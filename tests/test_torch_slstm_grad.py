"""The sLSTM layer's gradient in the PyTorch port (``SLSTMCellFn``
through ``slstm_scan`` / ``slstm_scan_stacked``, its CPU path: the plain
forward with its saved gate sums, then the plain BPTT backward) against
``jax.grad`` of the reference's ``slstm_scan`` on the same numpy inputs.

Tolerance: rtol 1e-4, atol 1e-5 (f32 on the CPU; the two sum the
recurrent products and the gradient of r in other orders).

The tie: from the zero state, step 0 has m = log_i, so i = 1 and n = 1
exactly in every row and head, where max(|n|, 1) ties. ``jnp.maximum``'s
derivative gives each side half; ``torch.clamp_min`` passes all of it to
|n|. ``test_step0_tie_takes_half`` pins the half; there the split
cancels out of the inputs' gradients (n_0 is 1 whatever the inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recurrent import slstm_scan as jscan
from repro_torch.kernels.slstm_cell import slstm_cell_bwd
from repro_torch.kernels.slstm_cell.ops import slstm_cell
from repro_torch.kernels.slstm_cell.ref import (
    _tie_grad,
    recurrent_grad,
    slstm_cell_bwd_ref,
    slstm_cell_ref,
)
from repro_torch.models.recurrent import slstm_scan, slstm_scan_stacked

TOL = dict(rtol=1e-4, atol=1e-5)


def _layer(c, b, s, d, heads, seed):
    """C clients' sLSTM parameters (the reference's init scales, a
    nonzero bias), their inputs and an output weighting, as numpy."""
    rng = np.random.default_rng(seed)
    hd = d // heads
    p = {"wx": rng.standard_normal((c, d, 4 * d)) / np.sqrt(d),
         "r": rng.standard_normal((c, heads, hd, 4 * hd)) / np.sqrt(hd),
         "b": 0.1 * rng.standard_normal((c, 4 * d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((c, b, s, d)).astype(np.float32)
    w = rng.standard_normal((c, b, s, d)).astype(np.float32)
    return p, x, w


def _jax_grads(p, x, w, heads):
    """jax.grad of sum(h * w) over every client's layer (vmapped)."""
    def loss(p, x):
        hs = jax.vmap(lambda pc, xc: jscan(pc, xc, heads)[0])(p, x)
        return jnp.sum(hs * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _torch_grads(p, x, w, heads, stacked):
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    if stacked:
        hs = slstm_scan_stacked(tp, tx, heads)
    else:  # one client at a time through the unstacked layer
        hs = torch.stack([slstm_scan({k: v[i] for k, v in tp.items()}, tx[i],
                                     heads, return_state=False)[0]
                          for i in range(x.shape[0])])
    torch.sum(hs * torch.from_numpy(w)).backward()
    return {k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy()


@pytest.mark.parametrize("c,b,s,d,heads,stacked", [
    (1, 3, 8, 32, 2, False), (1, 2, 5, 16, 4, False), (1, 4, 12, 24, 3, False),
    (3, 2, 7, 32, 2, True), (2, 5, 4, 16, 1, True),
])
def test_slstm_grads_match_jax(c, b, s, d, heads, stacked):
    p, x, w = _layer(c, b, s, d, heads, seed=s + d)
    want_p, want_x = _jax_grads(p, x, w, heads)
    got_p, got_x = _torch_grads(p, x, w, heads, stacked)
    np.testing.assert_allclose(got_x, want_x, **TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], err_msg=k, **TOL)
    assert slstm_cell_bwd.launches == 0  # the CPU path launches nothing


def test_step0_tie_takes_half():
    """At step 0 every row's n is exactly 1, the tie of max(|n|, 1): the
    backward splits its gradient half and half there, as jnp.maximum's
    derivative does (``_tie_grad`` against jax.grad of jnp.maximum, at
    ties and off them), and the layer's gradients match jax.grad. The
    split does not reach the inputs' gradients: n_0 = i_0 = exp(log_i -
    m_0) with m_0 = log_i is 1 whatever the inputs, so the adjoint through
    n_0 cancels against the stabilizer's (autograd through the clamp_min
    forward, which passes the whole gradient, agrees to rounding)."""
    c, b, s, d, heads = 1, 4, 3, 16, 2
    p, x, w = _layer(c, b, s, d, heads, seed=11)
    want_p, want_x = _jax_grads(p, x, w, heads)
    got_p, got_x = _torch_grads(p, x, w, heads, stacked=True)
    np.testing.assert_allclose(got_x, want_x, **TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], err_msg=k, **TOL)

    hd = d // heads
    pre = (x[0] @ p["wx"][0] + p["b"][0]).reshape(b, s, 4, heads, hd)
    pre = torch.from_numpy(pre.transpose(0, 3, 1, 2, 4).copy())
    _, saved = slstm_cell_ref(pre, torch.from_numpy(p["r"][0]), save=True)
    assert torch.equal(saved[:, :, 0, 5], torch.ones_like(saved[:, :, 0, 5]))  # n

    a = np.array([1.0, 1.0, 2.0, 0.5, -3.0], np.float32)
    bb = np.array([1.0, 0.5, 1.0, 1.0, -3.0], np.float32)
    ja, jb = jax.vmap(jax.grad(jnp.maximum, argnums=(0, 1)))(a, bb)
    ga, gb = _tie_grad(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    assert ga[0] == 0.5  # and torch.clamp_min would pass 1.0


@pytest.mark.parametrize("c,b,s,hd,heads", [(1, 3, 6, 8, 2), (2, 2, 9, 4, 3)])
def test_plain_backward_matches_autograd_of_tie_corrected_forward(c, b, s, hd,
                                                                  heads):
    """slstm_cell_bwd_ref and recurrent_grad against float64 autograd of
    the recurrence written with torch.maximum at both maxima (whose
    autograd splits a tie half and half, as jnp.maximum's does)."""
    rng = np.random.default_rng(hd + s)
    pre = torch.from_numpy(rng.standard_normal((c * b, heads, s, 4, hd)))
    r = torch.from_numpy(rng.standard_normal((c, heads, hd, 4 * hd)) / np.sqrt(hd))
    wt = torch.from_numpy(rng.standard_normal((c * b, heads, s, hd)))
    p64, r64 = pre.clone().requires_grad_(True), r.clone().requires_grad_(True)
    cst = torch.zeros((c * b, heads, hd), dtype=torch.float64)
    n, m, h, hs = cst, cst - 1e30, cst, []
    for t in range(s):
        rec = torch.einsum("cbhi,chij->cbhj", h.reshape(c, b, heads, hd), r64)
        a = p64[:, :, t] + rec.reshape(c * b, heads, 4, hd)
        log_f = torch.nn.functional.logsigmoid(a[:, :, 2])
        m_new = torch.maximum(log_f + m, a[:, :, 1])
        i_g, f_g = torch.exp(a[:, :, 1] - m_new), torch.exp(log_f + m - m_new)
        cst, n, m = f_g * cst + i_g * torch.tanh(a[:, :, 0]), f_g * n + i_g, m_new
        h = torch.sigmoid(a[:, :, 3]) * cst / torch.maximum(n.abs(), torch.ones_like(n))
        hs.append(h)
    torch.sum(torch.stack(hs, 2) * wt).backward()
    out, saved = slstm_cell_ref(pre.float(), r.float(), save=True)
    dpre = slstm_cell_bwd_ref(saved, r.float(), wt.float())
    np.testing.assert_allclose(dpre.numpy(), p64.grad.numpy(), **TOL)
    np.testing.assert_allclose(recurrent_grad(out, dpre, r.float()).numpy(),
                               r64.grad.numpy(), **TOL)


def test_refusals_under_autograd():
    """A state's gradient waits for ROADMAP item 15c-2; the cell's
    backward takes f32, which the models give it in bf16 compute too
    (item 15c-1), so a bf16 input with a gradient still refuses. Without
    a gradient the same calls run."""
    pre = torch.zeros((2, 1, 3, 4, 8), requires_grad=True)
    r = torch.zeros((1, 8, 32))
    state = tuple(torch.zeros((2, 1, 8)) for _ in range(4))
    with pytest.raises(NotImplementedError, match="item 15c-2"):
        slstm_cell(pre, r, initial_state=state)
    with pytest.raises(NotImplementedError, match="item 15c-2"):
        slstm_cell(pre, r, return_state=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        slstm_cell(pre.detach().bfloat16().requires_grad_(True), r.bfloat16())
    with torch.no_grad():
        out, final = slstm_cell(pre, r, initial_state=state, return_state=True)
    assert out.shape == (2, 1, 3, 8) and len(final) == 4


def test_bwd_launcher_refuses_cpu_tensors():
    """No silent fallback: the backward kernel's launcher raises on CPU
    tensors before it builds or launches anything."""
    before = slstm_cell_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        slstm_cell_bwd.slstm_cell_bwd_cuda(torch.zeros(2, 1, 3, 7, 8),
                                           torch.zeros(1, 8, 32),
                                           torch.zeros(2, 1, 3, 8))
    assert slstm_cell_bwd.launches == before
