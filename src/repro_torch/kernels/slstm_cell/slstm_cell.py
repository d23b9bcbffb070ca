"""Launcher of the CUDA sLSTM cell kernel (``slstm_cell.cu``).

``slstm_cell_cuda(pre_x, r)`` checks its tensors, allocates the output
(and, with ``return_state``, the final state), launches the kernel on
the current stream and adds one to ``launches``; ``initial_state``
starts the recurrence from a given (c, n, m, h) instead of the zero
state. ``r`` of shape (C, H, hd, 4hd) stacks C clients' weights over the
rows of ``pre_x`` (C*B of them, client-major): one launch for all C.
With ``save`` the kernel also writes what the backward
(``slstm_cell_bwd.py``) reads: each step's gate sums and (c, n, m). It takes CUDA tensors only: there is no CPU path here
(``ops.slstm_cell`` routes CPU tensors to ``ref.py``). The library is
built on first call, never at import.

``plan(batch, n_heads, hd, max_clusters)`` is the kernel's partition of
a call (the ``plan`` function of ``slstm_cell.cu``, kept here in Python
so that the CPU tests can check it): clusters of CTAs a head and row
group, each CTA owning a slice of the head's units with r_h's columns
for them in its shared memory, at most ``max_clusters`` clusters where
the heads allow, so that all run at once. ``kernel_plan`` asks the built
library for its plan, the cluster budget the card gave it and how many
of the plan's clusters the card holds at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_cell.ref import zero_state as _zero_state

SOURCE = Path(__file__).with_name("slstm_cell.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

# kMaxHd in slstm_cell.cu: a CTA of a cluster of 8 holds its hd/8 units'
# four gate columns of r_h (2 * hd^2 bytes in f32, 128 KiB at 256) and two
# h buffers in its shared memory; 8 CTAs is the portable cluster size
MAX_HEAD_DIM = 256
# the kernel's constants (slstm_cell.cu), mirrored by plan()
MAX_UNITS, UNIT_LANES, MAX_ROWS = 32, 8, 32
CLUSTER_UNSCHEDULABLE = -1  # the C entry point's answer when no cluster fits
BARRIER_BYTES = 16  # two mbarriers, one an h buffer

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
SAVE_SLOTS = 7  # a step's saved floats a unit: a_z, a_i, a_f, a_o, c, n, m
_fns: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's partition of a (batch, n_heads, hd) call."""
    cluster: int          # CTAs a cluster: 1, 2, 4 or 8
    units: int            # units a CTA (the last CTA may own fewer)
    unit_pad: int         # units rounded up to the 8 unit lanes
    rows: int             # rows a cluster, a multiple of rows_per_thread
    rows_per_thread: int
    gates_per_thread: int  # 4, or 1 at 1 row (four lanes a unit)
    row_lanes: int        # rows / rows_per_thread
    groups: int           # row groups a head
    threads: int          # computing threads a CTA: 4 / gates * unit_pad * row_lanes
    hstride: int          # floats a row of an h buffer (4 mod 32)
    smem: int             # dynamic shared memory bytes a CTA

    def r_bytes(self, hd: int) -> int:
        """r_h's slice: hd inputs x unit_pad units x 4 gates, f32 (bf16 r
        is widened on load)."""
        return 16 * hd * self.unit_pad

    def h_bytes(self) -> int:
        """The two h buffers (t's parity), every row of the group, and
        their two barriers."""
        return 4 * 2 * self.rows * self.hstride + BARRIER_BYTES

    def tile(self, cta: int, thread: int, hd: int) -> tuple:
        """(head, group, [row of the group], unit or None, [gate]) that
        thread ``thread`` of CTA ``cta`` of the grid computes: unit None
        where its unit lane lies past its CTA's slice or past hd, or the
        thread is past ``threads``. The h of a (row, unit) is stored by
        the thread that computes its gate 0."""
        cid, rank = divmod(cta, self.cluster)
        head, group = divmod(cid, self.groups)
        gate_lanes = 4 // self.gates_per_thread
        tu, gl = divmod(thread, gate_lanes)
        lane_q, ul = divmod(tu, UNIT_LANES)
        rl = lane_q % self.row_lanes
        u = (lane_q // self.row_lanes) * UNIT_LANES + ul
        unit = rank * self.units + u
        ok = thread < self.threads and u < self.units and unit < hd
        rpt = self.rows_per_thread
        rows = [rl * rpt + k for k in range(rpt)]
        gates = [gl * self.gates_per_thread + g for g in range(self.gates_per_thread)]
        return head, group, rows, unit if ok else None, gates


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan(batch: int, n_heads: int, hd: int, max_clusters: int) -> Plan:
    """The partition ``slstm_cell.cu``'s plan() makes of a call: the
    smallest power-of-two cluster whose CTAs own at most 32 units each;
    max_clusters // n_heads row groups a head (at least one), at most 32
    rows a cluster; 1, 2 or 4 rows a thread; one gate a thread at 1 row
    (four times the threads), else all four."""
    if not (1 <= hd <= MAX_HEAD_DIM and batch >= 1 and n_heads >= 1
            and max_clusters >= 1):
        raise ValueError(f"no plan for batch {batch}, {n_heads} heads, hd {hd}")
    cluster = 1
    while cluster * MAX_UNITS < hd:
        cluster *= 2
    units = _ceil_div(hd, cluster)
    unit_pad = _ceil_div(units, UNIT_LANES) * UNIT_LANES
    per_head = max(1, max_clusters // n_heads)
    rows = min(MAX_ROWS, _ceil_div(batch, per_head))
    rpt = 4 if rows >= 16 else 2 if rows >= 8 else 1
    gpt = 1 if rows == 1 else 4
    row_lanes = _ceil_div(rows, rpt)
    rows = row_lanes * rpt
    hstride = _ceil_div(hd, 32) * 32 + 4
    return Plan(cluster=cluster, units=units, unit_pad=unit_pad, rows=rows,
                rows_per_thread=rpt, gates_per_thread=gpt, row_lanes=row_lanes,
                groups=_ceil_div(batch, rows),
                threads=4 // gpt * unit_pad * row_lanes, hstride=hstride,
                smem=16 * hd * unit_pad + 8 * rows * hstride + BARRIER_BYTES)


def kernel_plan(batch: int, n_heads: int, hd: int, dtype=torch.float32) -> tuple:
    """(the built kernel's Plan of the call, the cluster budget the
    current CUDA device gave it, the clusters of the plan the device
    holds at once), from ``slstm_cell_plan``."""
    fn = _build.load(SOURCE).slstm_cell_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 13)()
    err = fn(batch, n_heads, hd, int(dtype == torch.bfloat16),
             ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"slstm_cell_plan failed: CUDA error {err}")
    return Plan(*out[:11]), out[11], out[12]


def _fn(dtype):
    """The C entry point slstm_cell_stacked_<dtype>: three tensors, the
    save pointer, eight state pointers (null for the zero state, a state
    not written or nothing saved), five ints and the stream."""
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), f"slstm_cell_stacked_{_ENTRY[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check_state(state, b: int, h: int, hd: int, device) -> None:
    if len(state) != 4:
        raise ValueError(f"want the state (c, n, m, h), got {len(state)} tensors")
    for x in state:
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, hd)
                or not x.is_contiguous() or x.device != device):
            raise ValueError(f"want each state tensor float32, contiguous, "
                             f"{(b, h, hd)} on {device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def slstm_cell_cuda(pre_x: torch.Tensor, r: torch.Tensor, initial_state=None,
                    return_state: bool = False, save: bool = False):
    """pre_x (B, H, S, 4, hd) and r (H, hd, 4hd), or pre_x (C*B, H, S, 4,
    hd) and r (C, H, hd, 4hd), both f32 or both bf16, contiguous on one
    CUDA device, hd <= 256; initial_state None or (c, n, m, h), each a
    contiguous (C*B, H, hd) f32 tensor there. Returns h (C*B, H, S, hd)
    in their dtype, then the final (c, n, m, h) with ``return_state``,
    then with ``save`` the (C*B, H, S, 7, hd) f32 tensor of each step's
    gate sums (z, i, f, o) and state (c, n, m) after it."""
    global launches
    if pre_x.dtype not in _ENTRY or r.dtype != pre_x.dtype:
        raise ValueError(f"slstm_cell_cuda takes float32 or bfloat16 of one "
                         f"dtype, got pre_x {pre_x.dtype}, r {r.dtype}")
    if pre_x.dim() != 5 or pre_x.shape[3] != 4:
        raise ValueError(f"want pre_x (B, H, S, 4, hd), got {tuple(pre_x.shape)}")
    rows, h, s, _, hd = pre_x.shape
    clients = r.shape[0] if r.dim() == 4 else 1
    if (tuple(r.shape[-3:]) != (h, hd, 4 * hd) or r.dim() not in (3, 4)
            or rows % clients):
        raise ValueError(f"want r (H, hd, 4hd) = {(h, hd, 4 * hd)} or (C, H, "
                         f"hd, 4hd) with C dividing {rows} rows, got "
                         f"{tuple(r.shape)}")
    b = rows // clients
    if not (pre_x.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm_cell_cuda takes contiguous tensors")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_cell_cuda takes a head dim of at most "
                         f"{MAX_HEAD_DIM} (r_h's slice in a CTA's shared "
                         f"memory), got {hd}")
    if 8 * rows * h > 2**31 - 1:  # up to a cluster of 8 CTAs a (row, head) pair
        raise ValueError(f"{rows * h} (row, head) pairs exceed the grid")
    if initial_state is not None:
        _check_state(initial_state, rows, h, hd, pre_x.device)
    if pre_x.device.type != "cuda" or r.device != pre_x.device:
        raise ValueError(f"slstm_cell_cuda takes CUDA tensors on one device, "
                         f"got pre_x on {pre_x.device}, r on {r.device}")
    out = torch.empty((rows, h, s, hd), dtype=pre_x.dtype, device=pre_x.device)
    final = None
    if return_state and s == 0:  # nothing to run: the state passes through
        final = tuple(x.clone() for x in (
            initial_state if initial_state is not None
            else _zero_state(rows, h, hd, pre_x.device)))
    elif return_state:
        final = tuple(torch.empty((rows, h, hd), dtype=torch.float32,
                                  device=pre_x.device) for _ in range(4))
    saved = (torch.empty((rows, h, s, SAVE_SLOTS, hd), dtype=torch.float32,
                         device=pre_x.device) if save else None)

    def result():
        extra = ((final,) if return_state else ()) + ((saved,) if save else ())
        return (out, *extra) if extra else out

    if out.numel() == 0:
        return result()
    fn = _fn(pre_x.dtype)
    ptrs = tuple(None if x is None else x.data_ptr() for x in (
        saved, *(initial_state or (None,) * 4), *(final or (None,) * 4)))
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream(pre_x.device).cuda_stream
        err = fn(pre_x.data_ptr(), r.data_ptr(), out.data_ptr(), *ptrs,
                 clients, b, h, s, hd, stream)
    if err == CLUSTER_UNSCHEDULABLE:
        p = plan(MAX_ROWS, 1, hd, 1)  # the largest a CTA of this hd needs
        raise RuntimeError(f"slstm_cell: this card cannot hold one cluster of "
                           f"{p.cluster} CTAs with up to {p.smem} bytes of "
                           f"shared memory each")
    if err != 0:
        raise RuntimeError(f"slstm_cell kernel launch failed: CUDA error {err}")
    launches += 1
    return result()
