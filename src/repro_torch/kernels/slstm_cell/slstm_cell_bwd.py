"""Launcher of the CUDA sLSTM backward kernel (``slstm_cell_bwd.cu``).

``slstm_cell_bwd_cuda(saved, r, dhs)`` takes what the forward saved
(``slstm_cell_cuda(..., save=True)``), the recurrent weights and the
gradient of the output, allocates the gradient of the gate
pre-activations, launches the kernel on the current stream and adds one
to ``launches``. CUDA tensors only (``ops.SLSTMCellFn`` routes CPU
tensors to ``ref.slstm_cell_bwd_ref``); built on first call, never at
import.

``plan(batch, n_heads, hd, max_clusters)`` is the kernel's partition of
a call (the ``plan`` function of ``slstm_cell_bwd.cu``, kept here in
Python so that the CPU tests can check it): the forward's clusters, units
and row groups (``slstm_cell.plan``), each CTA holding r_h^T's rows of
its units' four gate columns, forming the partial recurrent gradient on
the tensor cores and reduce-scattering it to the CTAs that own its
inputs. ``kernel_plan`` asks the built
library for its plan, the cluster budget the card gave it and how many
of the plan's clusters the card holds at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_cell import slstm_cell as _fwd
from repro_torch.kernels.slstm_cell.slstm_cell import (
    CLUSTER_UNSCHEDULABLE,
    MAX_HEAD_DIM,
    SAVE_SLOTS,
)

SOURCE = Path(__file__).with_name("slstm_cell_bwd.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

THREADS = 512  # kThreads in slstm_cell_bwd.cu
WARPS = THREADS // 32
BARRIER_BYTES = 16  # two mbarriers, one a receive parity
_fns: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The backward kernel's partition of a (batch, n_heads, hd) call."""
    cluster: int   # CTAs a cluster: 1, 2, 4 or 8
    units: int     # units a CTA (the last CTA may own fewer)
    rows: int      # rows a cluster
    groups: int    # row groups a (client, head)
    kpad: int      # the product's depth: 4 * units gate columns, rounded to 8
    lda: int       # floats a row of the gate gradients (4 mod 32)
    ldr: int       # floats a row of the r_h^T slice: hd rounded to 32
    rows_pad: int  # rows rounded to the 16 of an m-tile
    n_tiles: int   # 8-input tiles of the partial: ceil(hd / 8)
    tiles_per_warp: int  # of them a warp takes: ceil(n_tiles / 16)
    smem: int      # dynamic shared memory bytes a CTA

    def own(self, rank: int, hd: int) -> int:
        """Units CTA ``rank`` of a cluster owns."""
        return max(0, min(self.units, hd - rank * self.units))

    def pairs(self, cta: int, thread: int, hd: int) -> list:
        """[(head, row of the head's batch, unit)] whose adjoint thread
        ``thread`` of CTA ``cta`` computes: pairs p = thread + q * THREADS
        (row p // units of the group, unit p % units of the CTA) of the
        CTA's own units. Rows at or past the batch compute on zeros and
        store nothing: the caller drops them."""
        cid, rank = divmod(cta, self.cluster)
        head, group = divmod(cid, self.groups)
        out = []
        for p in range(thread, self.rows * self.units, THREADS):
            row, u = divmod(p, self.units)
            if u < self.own(rank, hd):
                out.append((head, group * self.rows + row, rank * self.units + u))
        return out

    def sends(self, thread: int, hd: int) -> dict:
        """{destination rank: [(row of the group, its column)]} of the
        partial values thread ``thread`` of any CTA sends a message: the
        accumulator fragments of its warp's n-tiles (warp w takes n-tiles
        w * tiles_per_warp ..) in every m-tile, rows g and g + 8 of each
        m-tile and inputs 2t, 2t + 1 of each n-tile (g = lane // 4, t =
        lane % 4), below ``rows`` and hd, each to the CTA that owns it."""
        warp, lane = divmod(thread, 32)
        g, t = divmod(lane, 4)
        out: dict = {}
        for j in range(self.tiles_per_warp):
            tile = warp * self.tiles_per_warp + j
            if tile >= self.n_tiles:
                break
            for m, h, e in itertools.product(range(self.rows_pad // 16), (0, 1),
                                             (0, 1)):
                row, i = 16 * m + g + 8 * h, 8 * tile + 2 * t + e
                if row < self.rows and i < hd:
                    owner, col = divmod(i, self.units)
                    out.setdefault(owner, []).append((row, col))
        return out

    def message_bytes(self, rank: int, hd: int) -> int:
        """The bytes CTA ``rank`` expects a message: every CTA's partial
        of its units, all rows."""
        return self.cluster * self.rows * self.own(rank, hd) * 4


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def plan(batch: int, n_heads: int, hd: int, max_clusters: int) -> Plan:
    """The partition ``slstm_cell_bwd.cu``'s plan() makes of a call: the
    forward's cluster, units, rows and groups (``slstm_cell.plan``); the
    product's operands padded to its tiles and for conflict-free fragment
    loads (its depth to 8; the gate gradients to 16 rows of 4 mod 32
    floats; the slice's rows to hd rounded to 32, swizzled); shared
    memory for the slice, the step's gate gradients split into their TF32
    big and small parts, two parities of receive slots and their
    barriers."""
    if hd % 4 or hd < 4:
        raise ValueError(f"no plan for batch {batch}, {n_heads} heads, hd {hd}: "
                         f"the backward takes a head dim that is a multiple of 4")
    fwd = _fwd.plan(batch, n_heads, hd, max_clusters)
    kpad = _round_up(4 * fwd.units, 8)
    lda = _round_up(kpad, 32) + 4
    ldr = _round_up(hd, 32)
    rows_pad = _round_up(fwd.rows, 16)
    n_tiles = -(-hd // 8)
    return Plan(cluster=fwd.cluster, units=fwd.units, rows=fwd.rows,
                groups=fwd.groups, kpad=kpad, lda=lda, ldr=ldr, rows_pad=rows_pad,
                n_tiles=n_tiles, tiles_per_warp=-(-n_tiles // WARPS),
                smem=4 * (kpad * ldr + 2 * rows_pad * lda
                          + 2 * fwd.cluster * fwd.rows * fwd.units) + BARRIER_BYTES)


def kernel_plan(batch: int, n_heads: int, hd: int) -> tuple:
    """(the built kernel's Plan of the call, the cluster budget the
    current CUDA device gave it, the clusters of the plan the device
    holds at once), from ``slstm_cell_bwd_plan``."""
    fn = _build.load(SOURCE).slstm_cell_bwd_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 13)()
    err = fn(batch, n_heads, hd, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"slstm_cell_bwd_plan failed: CUDA error {err}")
    return Plan(*out[:11]), out[11], out[12]


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _build.load(SOURCE).slstm_cell_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def slstm_cell_bwd_cuda(saved: torch.Tensor, r: torch.Tensor,
                        dhs: torch.Tensor) -> torch.Tensor:
    """saved (C*B, H, S, 7, hd), r (H, hd, 4hd) or (C, H, hd, 4hd), dhs
    (C*B, H, S, hd), all f32 on one CUDA device, hd a multiple of 4 and at
    most 256. Returns dpre (C*B, H, S, 4, hd) f32, the gradient of each
    step's gate pre-activations."""
    global launches
    if any(x.dtype != torch.float32 for x in (saved, r, dhs)):
        raise ValueError(f"slstm_cell_bwd_cuda takes float32, got {saved.dtype}, "
                         f"{r.dtype}, {dhs.dtype}")
    if dhs.dim() != 4:
        raise ValueError(f"want dhs (C*B, H, S, hd), got {tuple(dhs.shape)}")
    rows, h, s, hd = dhs.shape
    clients = r.shape[0] if r.dim() == 4 else 1
    if (r.dim() not in (3, 4) or tuple(r.shape[-3:]) != (h, hd, 4 * hd)
            or rows % clients
            or tuple(saved.shape) != (rows, h, s, SAVE_SLOTS, hd)):
        raise ValueError(f"saved {tuple(saved.shape)}, r {tuple(r.shape)} do "
                         f"not match dhs {tuple(dhs.shape)}")
    if hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_cell_bwd_cuda takes a head dim that is a "
                         f"multiple of 4, at most {MAX_HEAD_DIM}; got {hd}")
    dev = dhs.device
    if dev.type != "cuda" or saved.device != dev or r.device != dev:
        raise ValueError(f"slstm_cell_bwd_cuda takes CUDA tensors on one "
                         f"device, got {saved.device}, {r.device}, {dev}")
    dpre = torch.empty((rows, h, s, 4, hd), dtype=torch.float32, device=dev)
    if dpre.numel() == 0:
        return dpre
    rt = r.transpose(-1, -2).contiguous()  # (C, H, 4hd, hd)
    saved, dhs = saved.contiguous(), dhs.contiguous()
    if any(x.data_ptr() % 16 for x in (saved, rt, dhs)):
        raise ValueError("slstm_cell_bwd_cuda takes 16-byte aligned tensors")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(saved.data_ptr(), rt.data_ptr(), dhs.data_ptr(),
                    dpre.data_ptr(), clients, rows // clients, h, s, hd, stream)
    if err == CLUSTER_UNSCHEDULABLE:
        p = plan(_fwd.MAX_ROWS, 1, hd, 1)  # the largest a CTA of this hd needs
        raise RuntimeError(f"slstm_cell_bwd: this card cannot hold one cluster "
                           f"of {p.cluster} CTAs with up to {p.smem} bytes of "
                           f"shared memory each")
    if err != 0:
        raise RuntimeError(f"slstm_cell_bwd kernel launch failed: CUDA error {err}")
    launches += 1
    return dpre
