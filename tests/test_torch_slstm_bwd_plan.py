"""The sLSTM backward kernel's partition of a call, on the CPU (JAX-free).

``slstm_cell_bwd.plan`` mirrors the ``plan`` function of
``slstm_cell_bwd.cu`` (``tests/test_torch_cuda.py`` holds the two equal on
the card), ``Plan.pairs`` the kernel's map from (CTA, thread) to the
(row, unit) pairs whose adjoint it computes, and ``Plan.sends`` the
partial recurrent gradients each thread sends. Checked here: every
(row, head, unit) of a call is computed by exactly one thread; each
CTA's message bytes (its barrier's expected count) equal what the
cluster's CTAs send it, into distinct slots; each CTA's shared memory
(r_h^T's slice, the step's gate gradients, two parities of receive
slots, two barriers) fits the 232,448 bytes a block may use for every
head dim that is a multiple of 4 up to 256, 1 to 1024 rows and 1 to 16
clients, with the product's operands padded for conflict-free fragment
loads; the cluster, units and row groups are the forward's.
"""
import itertools

import pytest

from repro_torch.kernels.slstm_cell import slstm_cell as fwd
from repro_torch.kernels.slstm_cell import slstm_cell_bwd as bwd

# clusters of 8 CTAs of the kernels an "NVIDIA H100 80GB HBM3" holds at
# once at hd = 256 (cudaOccupancyMaxActiveClusters; chip_smoke.py phase 9)
H100_CLUSTERS = 15
SMEM_LIMIT = 232_448  # shared memory a block may use on an H100


@pytest.mark.parametrize("b,h,hd", [
    (64, 64, 256), (64, 4, 256), (2, 4, 256),  # stacked, one client, serving
    (37, 4, 256), (70, 2, 64),                 # ragged last row group
    (3, 2, 100), (5, 3, 252), (9, 1, 36),      # hd not a multiple of the cluster
    (1, 1, 4), (33, 1, 4), (300, 2, 64),
])
@pytest.mark.parametrize("budget", [H100_CLUSTERS, 1, 64])
def test_every_row_and_unit_is_computed_once(b, h, hd, budget):
    p = bwd.plan(b, h, hd, budget)
    owned = {}
    for cta, thread in itertools.product(range(p.cluster * h * p.groups),
                                         range(bwd.THREADS)):
        for head, row, unit in p.pairs(cta, thread, hd):
            assert 0 <= head < h and 0 <= unit < hd
            if row < b:  # rows past B compute on zeros and store nothing
                owned[(row, head, unit)] = owned.get((row, head, unit), 0) + 1
    assert set(owned) == set(itertools.product(range(b), range(h), range(hd)))
    assert set(owned.values()) == {1}
    assert (p.groups - 1) * p.rows < b <= p.groups * p.rows


@pytest.mark.parametrize("b,n_heads,hd", [
    (64, 64, 256), (2, 4, 256), (37, 4, 256), (3, 2, 100), (5, 3, 252),
    (9, 1, 36), (1, 1, 4), (300, 2, 64), (1000, 1, 128),
])
def test_message_bytes_are_what_the_cluster_sends(b, n_heads, hd):
    """Every CTA runs the same threads; a message into CTA k is the sum
    over the cluster's CTAs of what their threads send k: rows x own
    units from each, each (row, column) of its slot once."""
    p = bwd.plan(b, n_heads, hd, H100_CLUSTERS)
    into = {}
    for thread in range(bwd.THREADS):
        for owner, cells in p.sends(thread, hd).items():
            into.setdefault(owner, []).extend(cells)
    for rank in range(p.cluster):
        cells = into.get(rank, [])
        assert len(cells) == len(set(cells))  # one store a slot cell
        assert set(cells) == set(itertools.product(range(p.rows),
                                                   range(p.own(rank, hd))))
        # the same from each of the cluster's CTAs, into its own slot
        assert 4 * p.cluster * len(cells) == p.message_bytes(rank, hd)
        assert p.own(rank, hd) >= 1  # no idle CTA: every barrier counts bytes
    assert set(into) == set(range(p.cluster))


@pytest.mark.parametrize("clients", [1, 2, 4, 16])
def test_shared_memory_fits_at_every_head_dim(clients):
    for hd, b in itertools.product(range(4, fwd.MAX_HEAD_DIM + 1, 4),
                                   (1, 2, 7, 16, 33, 64, 100, 1024)):
        for heads in (1, 4):
            p = bwd.plan(b, clients * heads, hd, H100_CLUSTERS)
            slice_bytes = 4 * p.kpad * p.ldr
            grads = 2 * 4 * p.rows_pad * p.lda  # TF32 big and small parts
            slots = 2 * 4 * p.cluster * p.rows * p.units
            assert p.smem == slice_bytes + grads + slots + bwd.BARRIER_BYTES
            assert p.smem <= SMEM_LIMIT, (b, clients, heads, hd, p)
            assert p.rows <= fwd.MAX_ROWS and p.units <= fwd.MAX_UNITS
            # the product's operands: every gate column, row and input
            assert p.kpad >= 4 * p.units and p.kpad % 8 == 0
            assert p.rows_pad >= p.rows and p.rows_pad % 16 == 0
            assert p.ldr >= 8 * p.n_tiles >= hd and p.lda >= p.kpad
            assert p.tiles_per_warp * bwd.WARPS >= p.n_tiles
            assert p.tiles_per_warp <= 2 and p.rows_pad <= 32  # the kernel's arrays
            # conflict-free fragment loads: ldmatrix's 8 rows of 16 bytes at
            # g * lda, and the slice's swizzle spreads t * ldr + g over 32
            # banks in rows of whole 32-float blocks
            assert p.lda % 32 == 4 and p.ldr % 32 == 0
    widest = bwd.plan(10**6, 1, fwd.MAX_HEAD_DIM, 1)
    assert widest.rows == fwd.MAX_ROWS and widest.smem == 230_416


@pytest.mark.parametrize("b,n_heads,hd", [
    (64, 64, 256), (64, 4, 256), (2, 4, 256), (8, 4, 256), (3, 2, 100),
    (1000, 1, 64),
])
def test_the_forwards_clusters_and_row_groups(b, n_heads, hd):
    """The backward partitions a call as the forward does."""
    p, f = bwd.plan(b, n_heads, hd, H100_CLUSTERS), fwd.plan(b, n_heads, hd,
                                                             H100_CLUSTERS)
    assert (p.cluster, p.units, p.rows, p.groups) == (f.cluster, f.units, f.rows,
                                                      f.groups)


def test_the_stacked_training_shape():
    """16 clients x 4 heads of 64 rows: 128 clusters of 8 CTAs of 32 rows;
    a CTA's product is (32 x 128) x (128 x 256), two m-tiles and two
    n-tiles a warp."""
    p = bwd.plan(64, 16 * 4, 256, H100_CLUSTERS)
    assert (p.cluster, p.units, p.rows, p.groups) == (8, 32, 32, 2)
    assert (p.kpad, p.rows_pad, p.n_tiles, p.tiles_per_warp) == (128, 32, 32, 2)
    assert 16 * 4 * p.groups == 128


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 1, 6, 15), (1, 1, 0, 15), (1, 1, 260, 15), (0, 1, 8, 15),
                 (1, 0, 8, 15), (1, 1, 8, 0)):
        with pytest.raises(ValueError, match="no plan"):
            bwd.plan(*args)
