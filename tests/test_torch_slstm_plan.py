"""The sLSTM kernel's partition of a call, on the CPU (JAX-free).

``slstm_cell.plan`` mirrors the ``plan`` function of ``slstm_cell.cu``
(``tests/test_torch_cuda.py`` holds the two equal on the card), and
``Plan.tile`` the kernel's map from (CTA, thread) to rows and a unit.
Checked here: every (row, head, unit, gate) of a call is computed by
exactly one thread, including ragged row groups, a ragged last CTA of
units, H = 1 and any cluster budget; each CTA's shared memory (r_h's
slice, widened to f32 for bf16 r too, so one budget serves both dtypes,
the two h buffers and their barriers; the pre-activations are prefetched
into registers) fits the 227 KB a block may use at every head dim up to
256; clusters stay within the portable size of 8 CTAs; the serving and
LM shapes run in one wave of the clusters an H100 holds.
"""
import itertools

import pytest

from repro_torch.kernels.slstm_cell import slstm_cell as launcher

# clusters of 8 CTAs of the kernel an "NVIDIA H100 80GB HBM3" holds at once
# at hd = 256 (cudaOccupancyMaxActiveClusters; chip_smoke.py phase 9)
H100_CLUSTERS = 15
SMEM_LIMIT = 227 * 1024  # shared memory a block may use on an H100


@pytest.mark.parametrize("b,h,hd", [
    (64, 4, 256), (2, 4, 256), (8, 4, 256),  # the serving and LM shapes
    (65, 4, 256), (17, 4, 256),              # ragged last row group
    (37, 1, 256), (10, 4, 256),              # H = 1; B not a multiple of rows
    (3, 2, 100), (5, 3, 255),                # hd not a multiple of the cluster
    (1, 1, 8), (2, 4, 8), (1, 2, 16), (1, 1, 32), (300, 2, 64),
    (128, 8, 256),                           # 32 rows a cluster
])
@pytest.mark.parametrize("budget", [H100_CLUSTERS, 1, 64])
def test_every_row_and_unit_is_owned_once(b, h, hd, budget):
    p = launcher.plan(b, h, hd, budget)
    owned = {}
    for cta, thread in itertools.product(range(p.cluster * h * p.groups),
                                         range(p.threads)):
        head, group, rows, unit, gates = p.tile(cta, thread, hd)
        assert 0 <= head < h and 0 <= group < p.groups
        if unit is None:  # a padded unit lane: computes on zeros, stores nothing
            continue
        for row, gate in itertools.product(rows, gates):
            assert 0 <= row < p.rows
            row_b = group * p.rows + row
            if row_b < b:  # rows past B compute on zeros and store nothing
                key = (row_b, head, unit, gate)
                owned[key] = owned.get(key, 0) + 1
    want = set(itertools.product(range(b), range(h), range(hd), range(4)))
    assert set(owned) == want
    assert set(owned.values()) == {1}
    assert (p.groups - 1) * p.rows < b <= p.groups * p.rows


@pytest.mark.parametrize("n_heads", [1, 4, 16])
def test_shared_memory_fits_at_every_head_dim(n_heads):
    """At every hd <= 256 and every batch, including those that fill a
    cluster's 32 rows."""
    for hd, b in itertools.product(range(1, launcher.MAX_HEAD_DIM + 1),
                                   (1, 2, 8, 17, 64, 65, 1000, 10**6)):
        p = launcher.plan(b, n_heads, hd, H100_CLUSTERS)
        assert p.smem == p.r_bytes(hd) + p.h_bytes()
        assert p.smem <= SMEM_LIMIT, (b, n_heads, hd, p)
        assert p.hstride >= hd + 4 and p.hstride % 32 == 4  # bank spread
    widest = launcher.plan(10**6, n_heads, launcher.MAX_HEAD_DIM, 1)
    assert widest.rows == launcher.MAX_ROWS and widest.smem == 197_648


@pytest.mark.parametrize("hd", range(1, launcher.MAX_HEAD_DIM + 1, 5))
def test_clusters_are_portable(hd):
    for b, n_heads in itertools.product((1, 3, 64, 1000), (1, 4, 32)):
        p = launcher.plan(b, n_heads, hd, H100_CLUSTERS)
        assert p.cluster in (1, 2, 4, 8)  # the smallest that gives <= 32 units
        assert p.cluster == 1 or p.cluster // 2 * launcher.MAX_UNITS < hd
        assert p.cluster * p.units >= hd > (p.cluster - 1) * p.units  # no idle CTA
        assert p.units <= launcher.MAX_UNITS and p.unit_pad % launcher.UNIT_LANES == 0
        assert p.rows <= launcher.MAX_ROWS and p.rows % p.rows_per_thread == 0
        assert p.threads == 4 // p.gates_per_thread * p.unit_pad * p.row_lanes <= 256
        # the gate lanes of one unit gather by shuffles: whole warps
        assert p.gates_per_thread == 4 or p.threads % 32 == 0


def test_one_wave_at_the_serving_shapes():
    """At the recurrent encoder's 64 and 2 rows and the LM's 8, the row
    groups of the 4 heads fit the clusters an H100 holds at once."""
    for b in (64, 8, 2):
        p = launcher.plan(b, 4, 256, H100_CLUSTERS)
        assert (p.cluster, p.units) == (8, 32)
        assert p.groups == min(b, H100_CLUSTERS // 4)
        assert 4 * p.groups <= H100_CLUSTERS


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 1, launcher.MAX_HEAD_DIM + 1, 15), (0, 1, 8, 15),
                 (1, 0, 8, 15), (1, 1, 0, 15), (1, 1, 8, 0)):
        with pytest.raises(ValueError, match="no plan"):
            launcher.plan(*args)
