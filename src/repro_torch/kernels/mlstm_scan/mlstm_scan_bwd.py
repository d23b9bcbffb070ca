"""Launcher of the CUDA mLSTM-scan backward kernels (``mlstm_scan_bwd.cu``).

``mlstm_scan_bwd_cuda(q, k, v, log_f, h, dh, normalize=...)`` checks its
tensors, allocates the four gradients and the scratch of the call (the
chunk-boundary states, the scores, the normalize step's du and den, the
dlog_f partial sums), launches the kernels on the current stream and
adds one to ``launches``. A call is five launches of four kernels
(``KERNELS``): ``mlstm_bwd_state`` (the forward states),
``mlstm_bwd_scores``, ``mlstm_bwd_state`` again (the gradient states),
``mlstm_bwd_chunk`` and ``mlstm_bwd_dlogf`` (``LAUNCH_ORDER``), with or
without ``normalize``. It takes CUDA tensors only: there is no CPU path here
(``ops.MLSTMScanFn`` routes CPU tensors to ``ref.mlstm_scan_bwd_ref``).
The library is built on first call, never at import.

``plan(bh, seq, dk, dv, normalize, sms, per_sm)`` is the kernels'
partition of a call (``grids`` and the layouts in the source, kept here
in Python so that the CPU tests can check it): which CTA of which launch
owns which (b, h, chunk, tile); ``work_bytes`` the scratch it needs.
``kernel_plan`` asks the built library for its grids, the blocks an SM
holds and the shared memory, ``kernel_work_bytes`` for its scratch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("mlstm_scan_bwd.cu")

# Backward calls made by this process (each the LAUNCHES launches of
# LAUNCH_ORDER); callers reset it to 0 to count the calls of one run.
launches = 0

# the kernels' names
KERNELS = ("mlstm_bwd_state", "mlstm_bwd_scores", "mlstm_bwd_chunk",
           "mlstm_bwd_dlogf")
# the kernels one call launches, in order (kLaunches in the source)
LAUNCH_ORDER = ("mlstm_bwd_state", "mlstm_bwd_scores", "mlstm_bwd_state",
                "mlstm_bwd_chunk", "mlstm_bwd_dlogf")
LAUNCHES = len(LAUNCH_ORDER)
# the source's constants, mirrored by plan()
CHUNK = 64       # kL: the backward's own chunk, whatever the forward's
TILE = 64        # kTile: output columns of a chunk CTA; state tiles 64 x 64
SLICE = 32       # kTK: reduction slice of the staged products
RING = 2         # kRing: stages of the slice pipeline
LDA, LDB = SLICE + 4, TILE + 8
STAGE = 2 * CHUNK * LDA
WIDE = CHUNK * LDB
# dynamic shared memory of a CTA, the same at every shape: a chunk CTA's
# ring of (64, 32) slice pairs, its two score matrices and its k, q and
# du column tiles (64, 64) at a row stride of 72, five rows of per-step
# values and two of the states' column dv (the largest of the kernels')
CHUNK_SMEM = 4 * (RING * STAGE + 5 * WIDE + 7 * CHUNK)
STATE_SMEM = 4 * (2 * WIDE + 2 * CHUNK)
SCORE_SMEM = 4 * (RING * STAGE + 5 * CHUNK)
MAX_SMEM_BYTES = 232448
MAX_GRID = 2**31 - 1

_fns: dict = {}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round4(x: int) -> int:
    return _ceil_div(x, 4) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernels' partition of a (bh, seq, dk, dv, normalize) call."""
    chunks: int      # nc: chunks of CHUNK steps
    slots: int       # nc - 1: chunk-boundary states of each direction
    p_all: int       # P = dv (+ 1 with normalize): the states' columns
    pp: int          # P rounded up to 4: a state row's stride
    tiles: int       # column tiles of a chunk: ceil(max(dk, dv) / 64)
    tiles_j: int     # state tiles over dk
    tiles_p: int     # state tiles over P
    state_ctas: int  # CTAs of one state launch (one chunk: one slot, idle)
    score_ctas: int  # bh * chunks * 2
    chunk_ctas: int  # bh * chunks * tiles
    dlogf_ctas: int  # bh
    waves: dict      # {kernel: CTAs over the blocks the card holds at once}

    def ctas(self, kernel: str) -> int:
        return {"mlstm_bwd_state": self.state_ctas, "mlstm_bwd_scores": self.score_ctas,
                "mlstm_bwd_chunk": self.chunk_ctas,
                "mlstm_bwd_dlogf": self.dlogf_ctas}[kernel]

    def state_cta(self, i: int) -> tuple:
        """(bh, slot, first dk row, first state column) of state CTA i;
        slot None where the call has no state (one chunk). The forward
        launch's slot s is chunk s's summary, the reverse's chunk s + 1's."""
        pt = i % self.tiles_p
        i //= self.tiles_p
        jt = i % self.tiles_j
        i //= self.tiles_j
        slot = i % max(self.slots, 1)
        bh = i // max(self.slots, 1)
        return bh, slot if slot < self.slots else None, TILE * jt, TILE * pt

    def score_cta(self, i: int) -> tuple:
        """(bh, chunk, which) of score CTA i: which 0 dh v^T, 1 q k^T."""
        return i // 2 // self.chunks, (i // 2) % self.chunks, i % 2

    def chunk_cta(self, i: int) -> tuple:
        """(bh, chunk, first column) of chunk CTA i: columns first ..
        first + 63 of dq and dk (below dk) and of dv (below dv)."""
        return i // self.tiles // self.chunks, (i // self.tiles) % self.chunks, \
            TILE * (i % self.tiles)


def plan(bh: int, seq: int, dk: int, dv: int, normalize: bool, sms: int = 132,
         per_sm=None) -> Plan:
    """The partition ``grids`` in ``mlstm_scan_bwd.cu`` makes of a call.
    ``per_sm`` {kernel: blocks an SM holds at once} (default: one each)
    and ``sms`` set the waves."""
    if bh < 1 or seq < 1 or dk < 1 or dv < 1:
        raise ValueError(f"no plan for bh {bh}, seq {seq}, dk {dk}, dv {dv}")
    per_sm = per_sm or {}
    nc = _ceil_div(seq, CHUNK)
    p_all = dv + int(normalize)
    tiles_j, tiles_p = _ceil_div(dk, TILE), _ceil_div(p_all, TILE)
    tiles = _ceil_div(max(dk, dv), TILE)
    counts = {"mlstm_bwd_state": bh * max(nc - 1, 1) * tiles_j * tiles_p,
              "mlstm_bwd_scores": bh * nc * 2,
              "mlstm_bwd_chunk": bh * nc * tiles,
              "mlstm_bwd_dlogf": bh}
    if max(counts.values()) > MAX_GRID:
        raise ValueError(f"no plan for bh {bh}, seq {seq}, dk {dk}, dv {dv}: "
                         f"a grid exceeds {MAX_GRID} CTAs")
    waves = {name: _ceil_div(n, sms * max(per_sm.get(name, 1), 1))
             for name, n in counts.items()}
    return Plan(chunks=nc, slots=nc - 1, p_all=p_all, pp=_round4(p_all),
                tiles=tiles, tiles_j=tiles_j, tiles_p=tiles_p,
                state_ctas=counts["mlstm_bwd_state"],
                score_ctas=counts["mlstm_bwd_scores"],
                chunk_ctas=counts["mlstm_bwd_chunk"],
                dlogf_ctas=counts["mlstm_bwd_dlogf"], waves=waves)


def work_layout(bh: int, seq: int, dk: int, dv: int, normalize: bool) -> dict:
    """The scratch of a call (``work_of`` in the source), in floats from
    its start, each region a multiple of 4: du and den (normalize only),
    the forward and reverse states, the scores, the dlog_f partial sums,
    the state counters (ints); "floats" the total."""
    p = plan(bh, seq, dk, dv, normalize)
    sizes = (("du", bh * seq * dv if normalize else 0),
             ("den", bh * seq if normalize else 0),
             ("f", bh * p.slots * dk * p.pp), ("r", bh * p.slots * dk * p.pp),
             ("scores", bh * p.chunks * 2 * CHUNK * CHUNK),
             ("part", bh * p.tiles * seq),
             ("counters", 2 * bh * p.tiles_j * p.tiles_p))
    out, off = {}, 0
    for name, n in sizes:
        out[name] = off
        off += _round4(n)
    out["floats"] = off
    return out


def work_bytes(bh: int, seq: int, dk: int, dv: int, normalize: bool) -> int:
    """Bytes of scratch a call needs (``mlstm_bwd_work_bytes``)."""
    return 4 * work_layout(bh, seq, dk, dv, normalize)["floats"]


def _lib():
    return _build.load(SOURCE)


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _lib().mlstm_scan_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def kernel_plan(bh: int, seq: int, dk: int, dv: int, normalize: bool) -> tuple:
    """(the built kernels' Plan of the call on the current CUDA device,
    {kernel: blocks an SM holds at once}, {"state", "scores", "chunk":
    dynamic shared memory bytes a CTA, "launches": launches a call}), from
    ``mlstm_bwd_plan``."""
    fn = _lib().mlstm_bwd_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 15)()
    err = fn(bh, seq, dk, dv, int(normalize), ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mlstm_bwd_plan failed: CUDA error {err}")
    per_sm = dict(zip(KERNELS, out[4:8]))
    got = plan(bh, seq, dk, dv, normalize, sms=out[8], per_sm=per_sm)
    got = dataclasses.replace(got, chunks=out[9], tiles=out[10],
                              state_ctas=out[0], score_ctas=out[1],
                              chunk_ctas=out[2], dlogf_ctas=out[3])
    return got, per_sm, {"state": out[11], "scores": out[12], "chunk": out[13],
                         "launches": out[14]}


def kernel_work_bytes(bh: int, seq: int, dk: int, dv: int, normalize: bool) -> int:
    """The built kernel's scratch bytes (``mlstm_bwd_work_bytes``)."""
    fn = _lib().mlstm_bwd_work_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(bh, seq, dk, dv, int(normalize))


def mlstm_scan_bwd_cuda(q, k, v, log_f, h, dh, *, normalize: bool = True):
    """q, k (B, H, S, dk), v, h, dh (B, H, S, dv), log_f (B, H, S): float32,
    contiguous, on one CUDA device; h is the forward's output (read with
    ``normalize`` only). Returns (dq, dk, dv, dlog_f) in f32."""
    global launches
    named = (("q", q), ("k", k), ("v", v), ("log_f", log_f), ("h", h),
             ("dh", dh))
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"mlstm_scan_bwd_cuda takes float32, got {name} "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError("mlstm_scan_bwd_cuda takes contiguous tensors")
    if q.dim() != 4:
        raise ValueError(f"want q (B, H, S, dk), got {tuple(q.shape)}")
    b, nh, s, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    if (tuple(k.shape) != (b, nh, s, dk) or tuple(v.shape) != (b, nh, s, dv)
            or tuple(h.shape) != (b, nh, s, dv) or tuple(dh.shape) != (b, nh, s, dv)
            or tuple(log_f.shape) != (b, nh, s)):
        raise ValueError(f"want k {(b, nh, s, dk)}, v, h, dh (B, H, S, dv), "
                         f"log_f {(b, nh, s)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}, {tuple(log_f.shape)}")
    run = bool(b * nh and s and dk and dv)
    if run:
        plan(b * nh, s, dk, dv, normalize)  # raises where a grid overflows
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"mlstm_scan_bwd_cuda takes CUDA tensors on one "
                             f"device, got {name} on {x.device}")
    if not run:
        return tuple(torch.zeros_like(x) for x in (q, k, v, log_f))
    # the kernels write every entry
    dq, dkk, dvv, dlf = (torch.empty_like(x) for x in (q, k, v, log_f))
    work = torch.empty(work_bytes(b * nh, s, dk, dv, normalize) // 4,
                       dtype=torch.float32, device=q.device)
    ds = torch.empty_like(log_f) if normalize else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                    h.data_ptr(), dh.data_ptr(), dq.data_ptr(), dkk.data_ptr(),
                    dvv.data_ptr(), dlf.data_ptr(), work.data_ptr(),
                    None if ds is None else ds.data_ptr(), b * nh, s, dk, dv,
                    int(normalize), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan_bwd kernel launch failed: CUDA error {err}")
    launches += 1
    return dq, dkk, dvv, dlf
