"""The blend kernel's segment plan, on the CPU (JAX-free).

``blendavg.plan`` lays out the segment table and tiles that
``blendavg.cu`` reads, and ``Launch.columns`` mirrors the kernel's map
from (tile, thread) to a leaf's columns (``tests/test_torch_cuda.py``
holds the tree kernel equal to one-leaf launches on the card). Checked
here: every element of every leaf is blended by exactly one thread of
exactly one launch, at every row count (a thread takes 1, 2 or 4 units a
tile, so that it keeps 16 loads in flight); a leaf takes the 16-byte path
exactly when both its pointers are 16-byte aligned and its row is a whole
number of vectors;
a tree over the per-launch limit splits into ceil(leaves / 64) launches;
each grid stays within the SM count's worth of blocks.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core.encoders import EncoderConfig, init_client_models
from repro_torch.data.synthetic import TaskSpec
from repro_torch.kernels.blendavg import blendavg as launcher

H100_SMS = 132


def _coverage(launches, cols, itemsize):
    """How many times each element of each leaf is blended."""
    seen = [np.zeros(n, np.int64) for n in cols]
    for ln in launches:
        assert ln.width == launcher.VEC_BYTES // itemsize
        for tile, thread in itertools.product(range(ln.tiles), range(launcher.THREADS)):
            for leaf, c0, w in ln.columns(tile, thread):
                seen[leaf][c0:c0 + w] += 1
    return seen


def _aligned(cols, itemsize, misalign=()):
    """(n, x_addr, out_addr) at 512-byte aligned addresses, as the caching
    allocator hands them out, with the leaves in ``misalign`` offset."""
    out, addr = [], 1 << 20
    for i, n in enumerate(cols):
        off = itemsize if i in misalign else 0
        out.append((n, addr + off, addr + (1 << 19) + off))
        addr += 1 << 21
    return out


@pytest.mark.parametrize("rows", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("cols,misalign", [
    ((1024, 25, 4096, 1, 1000, 257), ()),    # heads of 25 and ragged columns
    ((8, 16, 24, 3000), (1, 3)),             # misaligned pointers go scalar
    ((0, 64, 0, 5), ()),                     # empty leaves launch nothing
    ((70000,), ()),                          # several tiles a leaf
])
def test_every_element_is_blended_once(itemsize, cols, misalign, rows):
    leaves = _aligned(cols, itemsize, misalign)
    launches = launcher.plan(leaves, itemsize, rows, H100_SMS)
    assert all(ln.per_thread == launcher.units_for(rows) for ln in launches)
    seen = _coverage(launches, cols, itemsize)
    for n, s in zip(cols, seen):
        assert (s == 1).all() and len(s) == n
    assert sum(len(ln.segments) for ln in launches) == sum(n > 0 for n in cols)


@pytest.mark.parametrize("rows", [4, 16])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_vector_and_scalar_paths_split_at_the_right_leaves(itemsize, rows):
    width = launcher.VEC_BYTES // itemsize
    cols = (1024, 25, width, width + 1, 3 * width, 7, 4096)
    leaves = _aligned(cols, itemsize, misalign=(4,))
    (ln,) = launcher.plan(leaves, itemsize, rows, H100_SMS)
    want = [n % width == 0 and i != 4 for i, n in enumerate(cols)]
    assert [s.vec for s in ln.segments] == want
    assert [s.units for s in ln.segments] == [
        n // width if v else n for n, v in zip(cols, want)]
    span = launcher.THREADS * launcher.units_for(rows)
    tiles = [-(-s.units // span) for s in ln.segments]
    assert [s.tile0 for s in ln.segments] == list(np.cumsum([0] + tiles[:-1]))
    assert ln.tiles == sum(tiles)


@pytest.mark.parametrize("n_leaves", [1, 30, 63, 64, 65, 128, 129, 200])
def test_a_large_tree_splits_into_the_stated_launches(n_leaves):
    cols = [(i % 7 + 1) * 40 for i in range(n_leaves)]
    launches = launcher.plan(_aligned(cols, 4), 4, 16, H100_SMS)
    assert len(launches) == launcher.launches_for(n_leaves) == -(-n_leaves // 64)
    assert all(len(ln.segments) <= launcher.MAX_SEGMENTS for ln in launches)
    assert [s.leaf for ln in launches for s in ln.segments] == list(range(n_leaves))
    seen = _coverage(launches, cols, 4)
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_grid_is_sized_from_the_sm_count(sms):
    for cols in ((131072,) * 16, (25,), (2097152, 1024)):
        (ln,) = launcher.plan(_aligned(cols, 4), 4, 16, sms)
        assert ln.grid == min(ln.tiles, launcher.CTAS_PER_SM * sms)
        assert 1 <= ln.grid <= ln.tiles


def test_full_width_round_groups_take_one_launch_each():
    """A full-width BlendFL model (d_hidden 1024, 4 layers, 64 x 128
    features, 25 labels, cut to d_hidden 8 here): groups A, B and M of
    13, 13 and 4 leaves each fit one launch; only the 25-wide bias leaves
    take the scalar path."""
    spec = TaskSpec("blendfl-1024", "multilabel", 25, 64, 128, 64, 128)
    models = init_client_models(torch.Generator().manual_seed(0), spec,
                                EncoderConfig(d_hidden=8, n_layers=4), device="cpu")
    groups = {"A": [models["f_A"], models["g_A"]], "B": [models["f_B"], models["g_B"]],
              "M": [models["g_M"]]}
    for name, want in (("A", 13), ("B", 13), ("M", 4)):
        leaves = tree_leaves(groups[name])
        assert len(leaves) == want
        cols = [x.numel() for x in leaves]
        launches = launcher.plan(_aligned(cols, 4), 4, 17 if name == "M" else 16,
                                 H100_SMS)
        assert len(launches) == launcher.launches_for(want) == 1
        scalar = {c for s, c in zip(launches[0].segments, cols) if not s.vec}
        assert scalar == {25}
