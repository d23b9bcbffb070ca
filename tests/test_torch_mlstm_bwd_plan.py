"""The mLSTM backward kernels' partition of a call, on the CPU (JAX-free).

``mlstm_scan_bwd.plan`` mirrors ``grids`` in ``mlstm_scan_bwd.cu`` and
``work_layout`` its scratch (``tests/test_torch_cuda.py`` holds both
equal to the built library on the card). Checked here: every (b, h,
chunk, state tile), every (b, h, chunk, score matrix) and every (b, h,
chunk, column) of dq, dk and dv is owned by exactly one CTA of its
launch, and the waves at each card budget; each CTA's shared memory fits at every
(dk, dv, normalize) the SIMT design before it took and beyond; hymba's shape
fills the card; and ``emulate``, which runs each CTA's arithmetic with
torch in f64 in the order of the plan (the states' in-place pass by the
last CTA of a tile, the scores through scratch, the normalize step from
the decayed row sums, each tile's dlog_f partial sums), gives the plain
backward's gradients: the decomposition the kernels implement.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_scan import mlstm_scan_bwd as launcher
from repro_torch.kernels.mlstm_scan.ref import (mlstm_grad_error_bound,
                                                mlstm_scan_bwd_ref, mlstm_scan_ref)

L, TILE = launcher.CHUNK, launcher.TILE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's small products, as
    ``_torch_parity.one_torch_thread`` gives the JAX-parity files (which
    import JAX, and this file does not): several test workers, each with
    a thread a core, contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (bh, seq, dk, dv, normalize): the two timed shapes, chunk-parallel at S =
# 2048 with hymba's heads, dk 1024 with the normalizer, ragged S and tiles
SHAPES = [(32, 128, 512, 512, True), (50, 2048, 16, 64, False),
          (2, 150, 64, 64, True), (6, 37, 16, 24, True), (1, 70, 8, 130, True),
          (1, 130, 1024, 64, True), (3, 64, 100, 1, False), (1, 1, 1, 1, True)]
# SMs and blocks an SM holds of each kernel: an H100's (132 SMs; two state
# and score CTAs, one chunk CTA), and others
BUDGETS = [(132, {"mlstm_bwd_state": 2, "mlstm_bwd_scores": 2, "mlstm_bwd_chunk": 1,
                  "mlstm_bwd_dlogf": 8}),
           (1, {}), (114, {"mlstm_bwd_chunk": 1}), (1000, {"mlstm_bwd_state": 4})]


def _old_smem(dk, dv, normalize):
    """Shared memory of the SIMT design's scan CTA: the shapes the
    launcher took before the tensor-core design."""
    p = max(dv + int(normalize), dk)
    return 4 * (-(-p // 32) * 32 * 64 + 2 * 64 * 33 + 2 * 64 * 65 + 3 * 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_is_owned_once(shape):
    bh, seq, dk, dv, normalize = shape
    p = launcher.plan(bh, seq, dk, dv, normalize)
    assert p.chunks == -(-seq // L) and p.slots == p.chunks - 1
    # the states: every (b, h, slot, row tile, column) of the dk x pp state
    # once (the last column tile's columns past P are padding, zero)
    owned = {}
    for i in range(p.state_ctas):
        b, slot, j0, p0 = p.state_cta(i)
        if slot is None:  # one chunk: the launch's CTAs have nothing to do
            assert p.slots == 0
            continue
        for col in range(p0, min(p0 + TILE, p.pp)):
            owned[(b, slot, j0, col)] = owned.get((b, slot, j0, col), 0) + 1
    want = set(itertools.product(range(bh), range(p.slots), range(0, dk, TILE),
                                 range(p.pp)))
    assert set(owned) == want and set(owned.values()) <= {1}
    # the scores: each (b, h, chunk) once a matrix, by the score launch,
    # whatever the column tiles that read them
    got = sorted(p.score_cta(i) for i in range(p.score_ctas))
    assert got == sorted(itertools.product(range(bh), range(p.chunks), range(2)))
    # the outputs: every (b, h, chunk, column) of dq, dk and dv once
    cols = {"dq": dk, "dk": dk, "dv": dv}
    owned = {name: {} for name in cols}
    for i in range(p.chunk_ctas):
        b, c, j0 = p.chunk_cta(i)
        assert 0 <= c < p.chunks and j0 < max(dk, dv)
        for name, width in cols.items():
            for col in range(j0, min(j0 + TILE, width)):
                owned[name][(b, c, col)] = owned[name].get((b, c, col), 0) + 1
    for name, width in cols.items():
        assert set(owned[name]) == set(itertools.product(
            range(bh), range(p.chunks), range(width))), name
        assert set(owned[name].values()) == {1}, name
    # consecutive chunk CTAs are the column tiles of one (b, h, chunk)
    assert [p.chunk_cta(i)[:2] for i in range(p.tiles)] == [(0, 0)] * p.tiles
    assert p.dlogf_ctas == bh
    assert launcher.LAUNCH_ORDER.count("mlstm_bwd_state") == 2
    assert set(launcher.LAUNCH_ORDER) == set(launcher.KERNELS)
    assert launcher.LAUNCHES == 5


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
@pytest.mark.parametrize("shape", SHAPES)
def test_waves_at_each_budget(shape, budget):
    """The partition does not depend on the card; its waves are each
    launch's CTAs over the blocks the card holds at once."""
    sms, per_sm = BUDGETS[budget]
    p = launcher.plan(*shape, sms=sms, per_sm=per_sm)
    one = launcher.plan(*shape)
    assert dataclasses.replace(p, waves=one.waves) == one
    for name in launcher.KERNELS:
        assert p.waves[name] == -(-p.ctas(name) // (sms * per_sm.get(name, 1)))


def test_shared_memory_fits_everywhere():
    """Every CTA of every kernel fits in an SM's shared memory at every
    shape: the layouts do not depend on it. So the launcher takes every
    (dk, dv, normalize) the SIMT design took (max(dk, dv + 1) up to 704)
    and beyond, dk 1024 with the normalizer among them."""
    limit = launcher.MAX_SMEM_BYTES
    assert max(launcher.CHUNK_SMEM, launcher.STATE_SMEM, launcher.SCORE_SMEM) <= limit
    assert launcher.STATE_SMEM <= 48 * 1024 and launcher.SCORE_SMEM <= 48 * 1024
    assert launcher.CHUNK_SMEM == 4 * (2 * 2 * 64 * 36 + 5 * 64 * 72 + 7 * 64)
    took = [(dk, dv, n) for dk in [*range(1, 1100, 7), 512, 704]
            for dv in [*range(1, 1100, 7), 512, 703] for n in (True, False)
            if _old_smem(dk, dv, n) <= limit]
    assert (512, 512, True) in took and (704, 703, True) in took
    assert (705, 64, True) not in took and (1024, 64, True) not in took
    for dk, dv, n in took + [(1024, 64, True), (1024, 1024, True), (2048, 16, False)]:
        launcher.plan(8, 300, dk, dv, n)  # no refusal


def test_hymba_fills_the_card():
    """hymba-1.5b's Mamba heads, (2 x 25) (b, h) pairs at S = 2048, dk 16,
    dv 64: 32 chunks a (b, h) run in parallel, so the state and chunk
    launches fill the 132 SMs of an H100 at least once, where the SIMT
    design ran 150 CTAs, each walking 32 chunks; every warp of a chunk CTA
    owns one of dq's and dk's 16 columns' 8-column tiles and four of dv's;
    the score launch's 3200 CTAs compute each chunk's two matrices once."""
    p = launcher.plan(50, 2048, 16, 64, False, sms=132, per_sm=BUDGETS[0][1])
    assert (p.chunks, p.tiles, p.chunk_ctas) == (32, 1, 1600)
    assert p.state_ctas == 50 * 31 and p.score_ctas == 50 * 32 * 2
    for name in ("mlstm_bwd_state", "mlstm_bwd_scores", "mlstm_bwd_chunk"):
        assert p.ctas(name) >= 132, name
    assert p.waves["mlstm_bwd_chunk"] == 13
    # xlstm-350m's: 2 chunks, 8 column tiles, 512 chunk CTAs
    x = launcher.plan(32, 128, 512, 512, True)
    assert (x.chunks, x.tiles, x.chunk_ctas, x.tiles_p) == (2, 8, 512, 9)
    assert x.score_ctas == 128


def test_work_layout_is_disjoint_and_aligned():
    for bh, seq, dk, dv, n in SHAPES:
        lay = launcher.work_layout(bh, seq, dk, dv, n)
        p = launcher.plan(bh, seq, dk, dv, n)
        sizes = {"du": bh * seq * dv * n, "den": bh * seq * n,
                 "f": bh * p.slots * dk * p.pp, "r": bh * p.slots * dk * p.pp,
                 "scores": bh * p.chunks * 2 * L * L,
                 "part": bh * p.tiles * seq,
                 "counters": 2 * bh * p.tiles_j * p.tiles_p}
        order = list(sizes)
        for a, b in zip(order, order[1:] + ["floats"]):
            assert lay[a] % 4 == 0 and lay[b] - lay[a] >= sizes[a]
            assert lay[b] - lay[a] < sizes[a] + 4
        assert launcher.work_bytes(bh, seq, dk, dv, n) == 4 * lay["floats"]


def test_refusals():
    for args in ((0, 8, 4, 4, True), (1, 0, 4, 4, True), (1, 8, 0, 4, False),
                 (1, 8, 4, 0, False), (2**20, 2**20, 64, 64, True)):
        with pytest.raises(ValueError, match="no plan"):
            launcher.plan(*args)


# ---- the kernels' arithmetic, CTA by CTA, in f64 ----

def _rows(x, b, t0, valid, c0, width):
    """x[b, t0:t0+valid, c0:c0+width] zero-padded to (L, width)."""
    out = torch.zeros((L, width), dtype=torch.float64)
    blk = x[b, t0:t0 + valid, c0:c0 + width]
    out[:blk.shape[0], :blk.shape[1]] = blk
    return out


def _decays(lf, b, c, seq):
    t0 = c * L
    x = torch.zeros(L, dtype=torch.float64)
    x[:min(L, seq - t0)] = lf[b, t0:t0 + L]
    return torch.cumsum(x, 0)


def emulate(q, k, v, lf, h, dh, normalize, scratch=None):
    """The kernels' decomposition of the backward, launch by launch and
    CTA by CTA as ``plan`` deals them: q, k (bh, S, dk), v, h, dh (bh, S,
    dv), lf (bh, S) in f64. Returns (dq, dk, dv, dlf); fills ``scratch``
    (a dict) with what the kernels keep in theirs: "f", "r" (bh, slots,
    dk, pp), "scores" (bh, chunks, 2, 64, 64), "du", "ds", "den", "part"
    (bh, tiles, S)."""
    bh, seq, dk = q.shape
    dv = v.shape[-1]
    p = launcher.plan(bh, seq, dk, dv, normalize)
    ones = torch.ones((bh, seq, 1), dtype=torch.float64)
    vt = torch.cat([v, ones], -1) if normalize else v
    f = torch.zeros((bh, max(p.slots, 1), dk, p.pp), dtype=torch.float64)
    r = torch.zeros_like(f)

    def states(out, a, b_op, reverse):
        done = {}
        for i in range(p.state_ctas):
            b, slot, j0, p0 = p.state_cta(i)
            if slot is None:
                continue
            c = slot + 1 if reverse else slot
            d = _decays(lf, b, c, seq)
            w = torch.exp(d) if reverse else torch.exp(d[-1] - d)
            valid = min(L, seq - c * L)
            rows, cols = min(TILE, dk - j0), min(TILE, p.pp - p0)
            at = _rows(a, b, c * L, valid, j0, TILE) * w[:, None]
            bt = _rows(b_op, b, c * L, valid, p0, TILE)
            blk = at.T @ bt
            out[b, slot, j0:j0 + rows, p0:p0 + cols] = blk[:rows, :cols]
            done[(b, j0, p0)] = done.get((b, j0, p0), 0) + 1
            if done[(b, j0, p0)] < p.slots:
                continue
            # the last CTA of the tile: the pass over the slots, in place
            steps = range(1, p.slots) if not reverse else range(p.slots - 1, 0, -1)
            for ch in steps:
                s = ch - 1 if reverse else ch
                src = s + 1 if reverse else s - 1
                decay = torch.exp(_decays(lf, b, ch, seq)[-1])
                out[b, s, j0:j0 + rows, p0:p0 + cols] += (
                    decay * out[b, src, j0:j0 + rows, p0:p0 + cols])

    states(f, k, vt, reverse=False)
    # the scores, and the normalize step's backward
    scores = torch.zeros((bh, p.chunks, 2, L, L), dtype=torch.float64)
    du, ds, den = dh.clone(), torch.zeros((bh, seq), dtype=torch.float64), \
        torch.ones((bh, seq), dtype=torch.float64)
    for b, c, which in map(p.score_cta, range(p.score_ctas)):
        valid = min(L, seq - c * L)
        a, b_op, dim = (q, k, dk) if which else (dh, v, dv)
        scores[b, c, which] = _rows(a, b, c * L, valid, 0, dim) @ \
            _rows(b_op, b, c * L, valid, 0, dim).T
        if not (normalize and which):
            continue
        d = _decays(lf, b, c, seq)
        decay = torch.tril(torch.exp(d[:, None] - d[None, :]))
        rs = (scores[b, c, 1] * decay).sum(1)[:valid]
        nprev = f[b, c - 1, :, dv] if c > 0 else torch.zeros(dk, dtype=torch.float64)
        rows = slice(c * L, c * L + valid)
        s = rs + torch.exp(d[:valid]) * (q[b, rows] @ nprev)
        dn = torch.clamp_min(s.abs(), 1.0)
        gate = torch.sign(s) * (s.abs() >= 1.0)
        du[b, rows] = dh[b, rows] / dn[:, None]
        ds[b, rows] = -(dh[b, rows] * h[b, rows]).sum(-1) / dn * gate
        den[b, rows] = dn
    dht = torch.cat([du, ds[..., None]], -1) if normalize else dh
    states(r, q, dht, reverse=True)
    # the chunks: inter-chunk products, the decayed scores, in-chunk sums
    out = [torch.zeros_like(x) for x in (q, k, v)]
    part = torch.zeros((bh, p.tiles, seq), dtype=torch.float64)
    for i in range(p.chunk_ctas):
        b, c, j0 = p.chunk_cta(i)
        t0, valid = c * L, min(L, seq - c * L)
        d = _decays(lf, b, c, seq)
        keep = torch.tril(torch.ones((L, L), dtype=torch.bool))
        decay = torch.where(keep, torch.exp(d[:, None] - d[None, :]), 0.0)
        pa = scores[b, c, 0].clone()
        if normalize:
            rows = slice(t0, t0 + valid)
            dnr = torch.ones(L, dtype=torch.float64)
            dsr = torch.zeros(L, dtype=torch.float64)
            dnr[:valid], dsr[:valid] = den[b, rows], ds[b, rows]
            pa = pa / dnr[:, None] + dsr[:, None]
        pa, pq = pa * decay, scores[b, c, 1] * decay
        kt, qt = _rows(k, b, t0, valid, j0, TILE), _rows(q, b, t0, valid, j0, TILE)
        ut = _rows(du, b, t0, valid, j0, TILE)
        aq = pa @ kt
        ak = pa.T @ qt
        av = pq.T @ ut
        # the slices over dv, the normalizer's column dv a rank-1 term
        ds_rows = _rows(ds[..., None], b, t0, valid, 0, 1)
        if c > 0:
            fs = _pad(f[b, c - 1, j0:j0 + TILE, :p.p_all], TILE)
            inter = _rows(du, b, t0, valid, 0, dv) @ fs[:, :dv].T
            if normalize:
                inter += ds_rows @ fs[:, dv:dv + 1].T
            aq += torch.exp(d)[:, None] * inter
        if c < p.chunks - 1:
            rs_ = r[b, c, :, :p.p_all]
            rt = _pad(rs_[j0:j0 + TILE], TILE)
            inter = _rows(v, b, t0, valid, 0, dv) @ rt[:, :dv].T
            if normalize:
                inter += rt[:, dv:dv + 1].T
            ak += torch.exp(d[-1] - d)[:, None] * inter
            rv = torch.zeros((dk, TILE), dtype=torch.float64)
            blk = rs_[:, j0:j0 + TILE]
            rv[:, :blk.shape[1]] = blk
            av += torch.exp(d[-1] - d)[:, None] * (_rows(k, b, t0, valid, 0, dk) @ rv)
        wq, wv = max(0, min(TILE, dk - j0)), max(0, min(TILE, dv - j0))
        out[0][b, t0:t0 + valid, j0:j0 + wq] = aq[:valid, :wq]
        out[1][b, t0:t0 + valid, j0:j0 + wq] = ak[:valid, :wq]
        out[2][b, t0:t0 + valid, j0:j0 + wv] = av[:valid, :wv]
        x = (qt * aq).sum(1) - (kt * ak).sum(1)
        part[b, j0 // TILE, t0:t0 + valid] = x[:valid]
    x = part.sum(1)
    dlf = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])
    if scratch is not None:
        scratch.update(f=f[:, :p.slots], r=r[:, :p.slots], scores=scores, du=du,
                       ds=ds, den=den, part=part)
    return (*out, dlf)


def _pad(x, rows):
    out = torch.zeros((rows, x.shape[1]), dtype=torch.float64)
    out[:x.shape[0]] = x
    return out


@pytest.mark.parametrize("bh,seq,dk,dv,normalize", [
    (2, 150, 16, 24, True),    # two chunks and a ragged tail
    (2, 150, 16, 24, False),
    (1, 37, 8, 20, True),      # one ragged chunk
    (1, 200, 70, 9, True),     # two state row tiles, four chunks
    (1, 96, 12, 130, False),   # three column tiles (dv past dk), the last ragged
    (1, 260, 4, 67, True),     # five chunks, two state column tiles
])
def test_emulated_kernels_match_the_plain_backward(bh, seq, dk, dv, normalize):
    rng = np.random.default_rng(seq + dk + dv)
    q, k = (rng.standard_normal((1, bh, seq, dk)).astype(np.float32) / np.sqrt(dk)
            for _ in range(2))
    v, dh = (rng.standard_normal((1, bh, seq, dv)).astype(np.float32) for _ in range(2))
    lf = np.log(rng.uniform(0.85, 0.999, (1, bh, seq))).astype(np.float32)
    q, k, v, dh, lf = (torch.from_numpy(x) for x in (q, k, v, dh, lf))
    h = mlstm_scan_ref(q, k, v, lf, normalize=normalize)
    want, dq_scale = mlstm_scan_bwd_ref(q, k, v, lf, dh, h=h, normalize=normalize,
                                        dq_scale=True)
    got = emulate(*(x[0].double() for x in (q, k, v, lf, h, dh)), normalize)
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv", "dlog_f"), got, want)):
        err = (g.float() - w[0]).abs()
        bound = mlstm_grad_error_bound(w[0], dq_scale[0] if i == 0 else None)
        assert bool((err <= bound).all()), (name, float((err / bound).max()))
