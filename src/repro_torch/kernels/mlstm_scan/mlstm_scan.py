"""Launcher of the CUDA mLSTM scan kernel (``mlstm_scan.cu``).

``mlstm_scan_cuda(q, k, v, log_f, ...)`` checks its tensors, allocates
h and, with ``return_state``, the final (C, n), launches the kernel on
the current stream and adds one to ``launches``. It takes CUDA tensors
only: there is no CPU path here (``ops.mlstm_scan`` routes CPU tensors
to ``ref.py``). The library is built on first call, never at import.

``plan(bh, dk, dv, chunk, active)`` is the kernel's partition of a call
(``make_plan`` in ``mlstm_scan.cu``, kept here in Python so that the CPU
tests can check it): CTAs of 64 columns of C; at chunk 64, in clusters
of 1, 2, 4 or 8 that share the chunk's scores, the largest cluster whose
grid takes no more waves than the cluster-free one; at other chunks
alone. ``kernel_plan`` asks the built library for its plan and the
clusters the card holds at once, ``kernel_smem_bytes`` for its shared
memory and ``kernel_score_tile`` for its deal of the score tiles to the
warps of a cluster.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("mlstm_scan.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

TILES = (16, 32, 64, 128)  # the chunk lengths the kernel is built for
CLUSTERS = (1, 2, 4, 8)    # the cluster sizes it may launch
SHARE_CHUNK = 64           # kShareChunk: the only chunk launched in clusters
# the kernel's constants (mlstm_scan.cu), mirrored by plan()
MAX_SMEM_BYTES = 232448    # kMaxSmem: dynamic shared memory a block may have
DV_BLOCK, LDV, WARPS = 64, 72, 8  # kDvBlock, kLdv, kWarps
BARRIER_BYTES = 16
CLUSTER_UNSCHEDULABLE = -1  # the C entry point's answer when no cluster fits

_fns: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's partition of a (bh, dk, dv) call at one chunk."""
    cluster: int     # CTAs a cluster: 1, 2, 4 or 8
    tk: int          # dk a q / k tile: 32, or 16 where shared memory is short
    blocks: int      # column blocks of 64 a (b, h)
    blocks_pad: int  # blocks rounded up to the cluster (CTAs past dv
                     # compute their share of the scores only)
    ctas: int        # bh * blocks_pad
    clusters: int    # ctas / cluster
    waves: int       # clusters over the clusters the card holds at once
    smem: int        # dynamic shared memory bytes a CTA

    def cta(self, i: int) -> tuple:
        """(bh, first column, columns, cluster rank) of CTA ``i``."""
        bh, cb = divmod(i, self.blocks_pad)
        return bh, DV_BLOCK * cb, DV_BLOCK, cb % self.cluster


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


def k_stages(tk: int) -> int:
    """The ring of k tiles: three at TK = 32 (a tile's state update shares
    a barrier phase with the next tile's products), two at TK = 16."""
    return 3 if tk == 32 else 2


def smem_bytes_tk(chunk: int, dk: int, tk: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes_tk`` in the
    source): the transposed C slice, n, two stages of q tiles and the
    ring of k tiles, the chunk's v, P (two buffers in a cluster), two
    sets of n's partial sums, the chunk's decays and q.n, two mbarriers."""
    dkp = _round_up(dk, 32)
    np_ = 2 if cluster > 1 else 1
    return 4 * (dkp * DV_BLOCK + dkp + (2 + k_stages(tk)) * chunk * tk
                + chunk * LDV + np_ * chunk * (chunk + 4) + 2 * WARPS * tk
                + 4 * chunk) + BARRIER_BYTES


def pick_tk(chunk: int, dk: int, cluster: int) -> int:
    """32 where it fits, else 16; 0 where neither does."""
    for tk in (32, 16):
        if smem_bytes_tk(chunk, dk, tk, cluster) <= MAX_SMEM_BYTES:
            return tk
    return 0


def smem_bytes(chunk: int, dk: int, cluster: int = 1) -> int:
    """Dynamic shared memory of one CTA at the TK the kernel picks, or
    the TK = 16 layout's (above the limit) where nothing fits
    (``mlstm_smem_bytes`` in the source gives -1 there)."""
    return smem_bytes_tk(chunk, dk, pick_tk(chunk, dk, cluster) or 16, cluster)


def plan(bh: int, dk: int, dv: int, chunk: int, active, cluster: int = 0) -> Plan:
    """The partition ``make_plan`` in ``mlstm_scan.cu`` makes of a call.
    ``active[c]`` (a mapping over CLUSTERS) is how many clusters of c CTAs
    the card holds at once (0 or missing: none). cluster 0: at chunk
    SHARE_CHUNK the largest c of 2, 4, 8 that is at most the column
    blocks, fits in shared memory, and whose grid takes no more waves than
    the cluster-free grid, else (and at every other chunk) 1 (the
    kernel's choice); cluster c: the partition at that size, its waves
    unchecked (what the choice is held against)."""
    if chunk not in TILES or bh < 1 or dk < 1 or dv < 1 or (
            cluster and cluster not in CLUSTERS):
        raise ValueError(f"no plan for bh {bh}, dk {dk}, dv {dv}, chunk "
                         f"{chunk}, cluster {cluster}")
    blocks = _ceil_div(dv, DV_BLOCK)

    def ok(c):
        return ((c == 1 or (chunk == SHARE_CHUNK and c <= blocks))
                and pick_tk(chunk, dk, c) != 0 and active.get(c, 0) >= 1)

    def shape(c):
        tk = pick_tk(chunk, dk, c)
        pad = _round_up(blocks, c)
        ctas = bh * pad
        return Plan(cluster=c, tk=tk, blocks=blocks, blocks_pad=pad, ctas=ctas,
                    clusters=ctas // c,
                    waves=_ceil_div(ctas // c, max(active.get(c, 0), 1)),
                    smem=smem_bytes_tk(chunk, dk, tk, c))

    if cluster:
        if not ok(cluster):
            raise ValueError(f"no plan for bh {bh}, dk {dk}, dv {dv}, chunk "
                             f"{chunk} with clusters of {cluster}")
        return shape(cluster)
    if not ok(1):
        raise ValueError(f"no plan for bh {bh}, dk {dk}, dv {dv}, chunk {chunk}")
    best = shape(1)
    waves1 = best.waves
    for c in CLUSTERS[1:]:
        if ok(c) and shape(c).waves <= waves1:
            best = shape(c)
    return best


def score_slots(chunk: int, cluster: int) -> int:
    """``score_slots`` in the source, the template argument NS of the
    instance a plan launches: the score tiles every warp computes."""
    mt = chunk // 16
    return _ceil_div(mt * mt, 4 * cluster)


def _lib():
    return _build.load(SOURCE)


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _lib().mlstm_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def kernel_plan(bh: int, dk: int, dv: int, chunk: int) -> tuple:
    """(the built kernel's Plan of the call on the current CUDA device,
    {c: clusters of c CTAs the device holds at once} for the sizes the
    plan considered), from ``mlstm_scan_plan``."""
    fn = _lib().mlstm_scan_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 12)()
    err = fn(bh, dk, dv, chunk, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mlstm_scan_plan failed: CUDA error {err}")
    active = {c: out[8 + i] for i, c in enumerate(CLUSTERS) if out[8 + i]}
    if out[0] == 0:
        raise ValueError(f"the kernel has no plan for bh {bh}, dk {dk}, dv {dv}, "
                         f"chunk {chunk}")
    return Plan(*out[:8]), active


def kernel_smem_bytes(chunk: int, dk: int, cluster: int = 1) -> int:
    """The built kernel's shared memory a CTA (``mlstm_smem_bytes``), -1
    where nothing fits."""
    fn = _lib().mlstm_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(chunk, dk, cluster)


def kernel_score_tile(chunk: int, cluster: int, rank: int, warp: int,
                      slot: int) -> int:
    """The built kernel's column tile of score slot ``slot`` of warp
    ``warp`` of cluster rank ``rank`` (``mlstm_score_tile``, the function
    the kernel deals its score tiles with; its row tile is warp % (chunk
    / 16)): -1 where the slot holds none, -2 out of range."""
    fn = _lib().mlstm_score_tile
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(chunk, cluster, rank, warp, slot)


def tile(chunk: int, s: int) -> int:
    """The kernel's chunk length for ``chunk`` at sequence length ``s``:
    the smallest of TILES that holds min(chunk, s), as the TPU kernel
    takes min(chunk, s). The result does not depend on it beyond f32
    rounding."""
    want = min(chunk, s)
    if chunk < 1 or want > TILES[-1]:
        raise ValueError(f"mlstm_scan_cuda takes a chunk of 1..{TILES[-1]}, "
                         f"got {chunk}")
    return next(t for t in TILES if t >= want)


def mlstm_scan_cuda(q, k, v, log_f, *, chunk: int = 64, normalize: bool = True,
                    return_state: bool = False):
    """q, k (B, H, S, dk), v (B, H, S, dv), log_f (B, H, S): float32,
    contiguous, on one CUDA device. Returns h (B, H, S, dv) in f32, and
    the final (C (B, H, dk, dv), n (B, H, dk)) with ``return_state``."""
    global launches
    named = (("q", q), ("k", k), ("v", v), ("log_f", log_f))
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"mlstm_scan_cuda takes float32, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("mlstm_scan_cuda takes contiguous tensors")
    if q.dim() != 4:
        raise ValueError(f"want q (B, H, S, dk), got {tuple(q.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    if (tuple(k.shape) != (b, h, s, dk) or tuple(v.shape) != (b, h, s, dv)
            or tuple(log_f.shape) != (b, h, s)):
        raise ValueError(f"want k {(b, h, s, dk)}, v (B, H, S, dv), log_f "
                         f"{(b, h, s)}; got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_f.shape)}")
    if b * h * _round_up(_ceil_div(max(dv, 1), DV_BLOCK), CLUSTERS[-1]) > 2**31 - 1:
        raise ValueError(f"{b * h} (batch, head) pairs exceed the grid")
    length = tile(chunk, max(s, 1))
    need = smem_bytes(length, dk)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"mlstm_scan_cuda at chunk {length} and dk {dk} needs "
                         f"{need} bytes of shared memory a block, above the "
                         f"{MAX_SMEM_BYTES} an SM gives: use a smaller chunk")
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"mlstm_scan_cuda takes CUDA tensors on one "
                             f"device, got {name} on {x.device}")
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=q.device)
    run = bool(b * h and s and dk and dv)
    c = n = None
    if return_state:  # a launch writes every entry; else the zero state
        new = torch.empty if run else torch.zeros
        c = new((b, h, dk, dv), dtype=torch.float32, device=q.device)
        n = new((b, h, dk), dtype=torch.float32, device=q.device)
    if run:
        fn = _fn()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                     out.data_ptr(), None if c is None else c.data_ptr(),
                     None if n is None else n.data_ptr(), b * h, s, dk, dv,
                     length, int(normalize), stream)
        if err == CLUSTER_UNSCHEDULABLE:
            raise RuntimeError(f"mlstm_scan: this card cannot hold one cluster "
                               f"of the plan at chunk {length}, dk {dk}")
        if err != 0:
            raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error {err}")
        launches += 1
    return (out, (c, n)) if return_state else out
