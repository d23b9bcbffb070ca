"""Launcher of the CUDA parameter-blend kernel (``blendavg.cu``).

``blend_tree_cuda(leaves, omega)`` blends a list of stacked leaves, each
(L, ...) with the same L and dtype, in one launch a group of at most
``MAX_SEGMENTS`` leaves, allocates each leaf's own output and adds one to
``launches`` a launch. ``blend_params_cuda(stacked, omega)`` is its
one-leaf form. Both take CUDA tensors only: there is no CPU path here
(``ops.blend_params`` routes CPU tensors to ``ref.py``). The library is
built on first call, never at import.

``plan`` cuts the leaves into the kernel's segments and tiles, as
``blendavg.cu`` reads them; ``Launch.columns`` mirrors the kernel's map
from (tile, thread) to a leaf's columns, so that the CPU tests can check
that every element of every leaf is blended exactly once.
"""
from __future__ import annotations

import ctypes
from array import array
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, on_device

SOURCE = Path(__file__).with_name("blendavg.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

MAX_ROWS = 256  # kMaxRows in blendavg.cu: omega lives in shared memory
MAX_SEGMENTS = 64  # kMaxSegs: leaves a launch's segment table holds
THREADS = 256  # kThreads
CTAS_PER_SM = 2  # kCtasPerSm: the kernel's __launch_bounds__ minimum
VEC_BYTES = 16  # one vector load of the 16-byte path

_ENTRY = {torch.float32: "blend_tree_f32", torch.bfloat16: "blend_tree_bf16"}
_fns: dict = {}
_sm_count: dict = {}


def units_for(rows: int) -> int:
    """Units a thread blends a tile (``units_for`` in blendavg.cu): the
    kernel keeps 16 loads in flight a thread, rows x units of them."""
    return 1 if rows > 8 else (2 if rows > 4 else 4)


class Segment(NamedTuple):
    """One leaf in a launch: its index in the caller's list, its column
    count n, whether it takes the 16-byte path, its units (16-byte
    vectors, or columns on the scalar path) and its first tile."""
    leaf: int
    n: int
    vec: bool
    units: int
    tile0: int


class Launch(NamedTuple):
    segments: tuple
    tiles: int
    grid: int
    width: int  # columns a 16-byte unit covers (4 f32, 8 bf16)
    per_thread: int  # units a thread takes a tile

    def columns(self, tile: int, thread: int) -> list:
        """[(leaf, first column, columns)] that ``thread`` of the block
        running ``tile`` blends, as ``blend_kernel`` maps them (none
        where the thread lies past its segment's end)."""
        seg = max((s for s in self.segments if s.tile0 <= tile),
                  key=lambda s: s.tile0)
        u0 = (tile - seg.tile0) * THREADS * self.per_thread + thread
        units = [u0 + i * THREADS for i in range(self.per_thread)]
        return [(seg.leaf, u * self.width, self.width) if seg.vec else (seg.leaf, u, 1)
                for u in units if u < seg.units]


def vector_ok(n: int, itemsize: int, x_addr: int, out_addr: int) -> bool:
    """Whether a leaf takes the 16-byte path: both pointers 16-byte
    aligned and each row a whole number of vectors (so that every row
    starts aligned too)."""
    return (n * itemsize) % VEC_BYTES == 0 and x_addr % VEC_BYTES == 0 \
        and out_addr % VEC_BYTES == 0


def _layout(cols, vecs, itemsize: int, rows: int, sm_count: int):
    """[(segments, tiles, grid)] a launch, each segment a plain tuple
    (leaf, n, vec, units, tile0): the work of ``plan`` without its
    named tuples, which the launcher reads on every call."""
    width = VEC_BYTES // itemsize
    span = THREADS * units_for(rows)
    cap = CTAS_PER_SM * sm_count
    out, segs, tile = [], [], 0
    for i, (n, vec) in enumerate(zip(cols, vecs)):
        if n <= 0:
            continue
        if len(segs) == MAX_SEGMENTS:
            out.append((segs, tile, min(tile, cap)))
            segs, tile = [], 0
        units = n // width if vec else n
        segs.append((i, n, vec, units, tile))
        tile += -(-units // span)
    if segs:
        out.append((segs, tile, min(tile, cap)))
    return out


def plan(leaves, itemsize: int, rows: int, sm_count: int) -> list:
    """The launches that blend ``leaves``, [(n, x_addr, out_addr)] of one
    dtype and ``rows`` rows, in order: consecutive groups of at most
    MAX_SEGMENTS non-empty leaves, each cut into tiles of THREADS x
    ``units_for(rows)`` units, with a grid of at most CTAS_PER_SM blocks
    an SM that walks its tiles with a stride."""
    cols = [n for n, _, _ in leaves]
    vecs = [vector_ok(n, itemsize, xa, oa) for n, xa, oa in leaves]
    return [Launch(tuple(Segment(*seg) for seg in segs), tiles, grid,
                   VEC_BYTES // itemsize, units_for(rows))
            for segs, tiles, grid in _layout(cols, vecs, itemsize, rows, sm_count)]


def launches_for(n_leaves: int) -> int:
    """Launches a tree of ``n_leaves`` non-empty leaves of one dtype takes."""
    return -(-n_leaves // MAX_SEGMENTS)


def _fn(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _sms(index: int) -> int:
    n = _sm_count.get(index)
    if n is None:
        n = _sm_count[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def blend_tree_cuda(leaves, omega: torch.Tensor) -> list:
    """leaves: contiguous (L, ...) f32 or bf16 tensors on one CUDA device,
    all of one dtype and the same L; omega (L,) f32 on that device,
    1 <= L <= 256. Returns each leaf's blend, shape leaf.shape[1:], in a
    tensor of its own."""
    global launches
    if not leaves:
        return []
    first = leaves[0]
    dt, dev = first.dtype, first.device
    if dt not in _ENTRY:
        raise ValueError(f"blend_tree_cuda takes float32 or bfloat16, got {dt}")
    if omega.dtype != torch.float32:
        raise ValueError(f"omega must be float32, got {omega.dtype}")
    rows = first.shape[0] if first.dim() else 0
    if omega.dim() != 1 or omega.shape[0] != rows:
        raise ValueError(f"want leaves (L, ...) and omega (L,), got "
                         f"{tuple(first.shape)} and {tuple(omega.shape)}")
    for x in leaves:
        if x.dtype != dt or x.dim() < 1 or x.shape[0] != rows or x.device != dev:
            raise ValueError(f"every leaf must be ({rows}, ...) {dt} on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError("blend_tree_cuda takes contiguous tensors")
    if not omega.is_contiguous():
        raise ValueError("blend_tree_cuda takes contiguous tensors")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"blend_tree_cuda takes 1..{MAX_ROWS} rows, got {rows}")
    if dev.type != "cuda" or omega.device != dev:
        raise ValueError(f"blend_tree_cuda takes CUDA tensors on one device, "
                         f"got a leaf on {dev}, omega on {omega.device}")
    item = first.element_size()
    outs, cols, vecs, ptrs = [], [], [], []
    for x in leaves:
        shape = x.shape[1:]  # unpacked: faster to parse than a torch.Size
        o = torch.empty(*shape, dtype=dt, device=dev) if shape else \
            torch.empty((), dtype=dt, device=dev)
        n, xp, op = o.numel(), x.data_ptr(), o.data_ptr()
        outs.append(o)
        cols.append(n)
        vecs.append(vector_ok(n, item, xp, op))
        ptrs.append((xp, op))
    groups = _layout(cols, vecs, item, rows, _sms(dev.index))
    if not groups:
        return outs
    fn = _fn(dt)
    with on_device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        for segs, tiles, grid in groups:
            table = array("q")
            for leaf, n, vec, _, tile0 in segs:
                table.extend((*ptrs[leaf], n, tile0, vec))
            err = fn(table.buffer_info()[0], len(segs), omega.data_ptr(), rows,
                     tiles, grid, stream)
            if err != 0:
                raise RuntimeError(f"blendavg kernel launch failed: CUDA error {err}")
            launches += 1
    return outs


def blend_params_cuda(stacked: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """stacked (L, N) f32/bf16 and omega (L,) f32, both contiguous on one
    CUDA device, 1 <= L <= 256. Returns the (N,) blend in stacked's dtype:
    one launch of the tree kernel over a single leaf."""
    if stacked.dim() != 2 or tuple(omega.shape) != (stacked.shape[0],):
        raise ValueError(f"want stacked (L, N) and omega (L,), got "
                         f"{tuple(stacked.shape)} and {tuple(omega.shape)}")
    return blend_tree_cuda([stacked], omega)[0]
