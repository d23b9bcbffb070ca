"""The mLSTM kernel's partition of a call, on the CPU (JAX-free).

``mlstm_scan.plan`` mirrors ``make_plan`` in ``mlstm_scan.cu``
(``tests/test_torch_cuda.py`` holds the two equal on the card, and the
shared memory the Python side computes equal to the kernel's). Checked
here: every column block of every (b, h) is owned by exactly one CTA,
for each cluster size and card budget; each CTA's shared memory fits at
chunks 16-128, at each cluster size, and at every dk the launcher
accepts (at least every dk the SIMT design took); a plan never takes
more waves than the cluster-free grid, and shares scores at chunk 64
only; the plan refuses what the kernel does not take. The kernel's deal
of the score tiles to the warps of a cluster runs on the device: the
card test ``test_mlstm_score_tiles_are_owned_once_on_card`` checks it
through the function the kernel calls.
"""
import itertools

import pytest

from repro_torch.kernels.mlstm_scan import mlstm_scan as launcher

# clusters of 1, 2, 4 and 8 CTAs of this kernel (one an SM) that an
# "NVIDIA H100 80GB HBM3" holds at once (cudaOccupancyMaxActiveClusters,
# tools/torch_mlstm_ablation.py), and other budgets
H100 = {1: 132, 2: 66, 4: 30, 8: 15}
BUDGETS = [H100, {1: 132, 2: 64, 4: 32, 8: 16}, {1: 1, 2: 1, 4: 1, 8: 1},
           {1: 1000, 2: 500, 4: 250, 8: 125}, {1: 132}]


def _old_smem(chunk, dk):
    """Shared memory of the SIMT design (PR 15-17): the shapes the
    launcher took before the tensor-core design."""
    dkp = -(-dk // 32) * 32
    return 4 * (dkp * 64 + dkp + 2 * chunk * 36 + chunk * 64
                + chunk * (chunk + 4) + 5 * chunk)


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
@pytest.mark.parametrize("bh,dv", [(32, 512), (3, 320), (5, 100), (1, 64),
                                   (7, 1), (2, 192), (300, 448)])
def test_every_column_block_is_owned_once(bh, dv, budget):
    for chunk, dk in ((64, 512), (16, 30), (128, 64)):
        p = launcher.plan(bh, dk, dv, chunk, BUDGETS[budget])
        owned = {}
        for i in range(p.ctas):
            b, c0, cols, rank = p.cta(i)
            assert rank == i % p.cluster  # clusters: consecutive CTAs of one (b, h)
            assert b == (i - rank) // p.blocks_pad
            for col in range(c0, min(c0 + cols, dv)):
                owned[(b, col)] = owned.get((b, col), 0) + 1
        assert set(owned) == set(itertools.product(range(bh), range(dv)))
        assert set(owned.values()) == {1}
        assert p.blocks_pad % p.cluster == 0 and p.blocks_pad - p.blocks < p.cluster
        assert p.cluster == 1 or p.cluster <= p.blocks
        assert p.clusters * p.cluster == p.ctas


@pytest.mark.parametrize("chunk", launcher.TILES)
@pytest.mark.parametrize("cluster", launcher.CLUSTERS)
def test_shared_memory_fits_at_every_dk(chunk, cluster):
    """Every dk the launcher accepts has a plan whose CTAs fit, at each
    cluster size the plan may take there, and the launcher accepts at
    least every dk the SIMT design took."""
    limit = launcher.MAX_SMEM_BYTES
    for dk in range(1, 1025):
        accepted = launcher.smem_bytes(chunk, dk) <= limit
        if _old_smem(chunk, dk) <= limit:
            assert accepted, (chunk, dk)
        fits = launcher.smem_bytes(chunk, dk, cluster) <= limit
        assert accepted or not fits  # a cluster never needs less
        if not fits or (cluster > 1 and chunk != launcher.SHARE_CHUNK):
            with pytest.raises(ValueError, match="no plan"):
                launcher.plan(8, dk, 512, chunk, H100, cluster=cluster)
            continue
        p = launcher.plan(8, dk, 512, chunk, H100, cluster=cluster)
        assert p.cluster == cluster
        assert p.smem <= limit and p.tk in (16, 32)
        assert p.smem == launcher.smem_bytes_tk(chunk, dk, p.tk, p.cluster)
        assert p.smem == launcher.smem_bytes(chunk, dk, cluster)
        # TK = 32 wherever it fits
        assert p.tk == 32 or launcher.smem_bytes_tk(chunk, dk, 32, p.cluster) > limit
    # the model path: xlstm-350m's chunk 64 at dk = 512 fits every size
    assert launcher.smem_bytes(64, 512, cluster) <= limit


@pytest.mark.parametrize("chunk", launcher.TILES)
@pytest.mark.parametrize("budget", range(len(BUDGETS)))
def test_a_plan_never_adds_a_wave(budget, chunk):
    active = BUDGETS[budget]
    for bh, dv, dk in itertools.product(
            (1, 3, 8, 16, 17, 32, 33, 64, 100, 256), (64, 100, 320, 512, 1024),
            (64, 512)):
        if launcher.smem_bytes(chunk, dk) > launcher.MAX_SMEM_BYTES:
            continue
        p = launcher.plan(bh, dk, dv, chunk, active)
        one = launcher.plan(bh, dk, dv, chunk, active, cluster=1)
        assert p.waves <= one.waves, (bh, dv, chunk, dk, p, one)
        if chunk != launcher.SHARE_CHUNK:  # other chunks run alone
            assert p == one
            continue
        # and it takes the largest cluster that does not
        for c in launcher.CLUSTERS:
            if c > p.cluster and c <= p.blocks and active.get(c, 0) >= 1 and (
                    launcher.pick_tk(chunk, dk, c)):
                assert launcher.plan(bh, dk, dv, chunk, active,
                                     cluster=c).waves > one.waves


def test_the_model_shape_shares_its_scores_in_two_waves():
    """xlstm-350m's mLSTM, (8 x 4) (b, h) pairs at dk = dv = 512, chunk 64:
    256 CTAs take two waves alone; clusters of 2 keep two on an H100 (128
    clusters, 66 at once), clusters of 4 would take three (64 clusters, 30
    at once) and clusters of 8 three (15), so the plan takes 2; a card
    that held 16 clusters of 8 would get 8."""
    p = launcher.plan(32, 512, 512, 64, H100)
    assert (p.cluster, p.waves, p.ctas, p.tk) == (2, 2, 256, 32)
    assert launcher.plan(32, 512, 512, 64, H100, cluster=4).waves == 3
    assert launcher.plan(32, 512, 512, 64, H100, cluster=8).waves == 3
    assert launcher.plan(32, 512, 512, 64, H100, cluster=1).waves == 2
    assert launcher.plan(32, 512, 512, 64, BUDGETS[1]).cluster == 8


@pytest.mark.parametrize("args", [
    (0, 64, 64, 64), (1, 0, 64, 64), (1, 64, 0, 64), (1, 64, 64, 48),
    (1, 64, 64, 256), (1, 900, 64, 64), (1, 353, 64, 128),
])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="no plan"):
        launcher.plan(*args, H100)


def test_plan_refuses_clusters_it_cannot_launch():
    for cluster, dv in ((3, 512), (16, 1024), (2, 64), (8, 320)):
        with pytest.raises(ValueError, match="no plan"):
            launcher.plan(4, 64, dv, 64, H100, cluster=cluster)
    with pytest.raises(ValueError, match="no plan"):  # the card holds none
        launcher.plan(4, 64, 512, 64, {1: 132}, cluster=4)
    with pytest.raises(ValueError, match="no plan"):
        launcher.plan(4, 64, 512, 64, {})
    # only chunk 64 shares its scores: no other chunk is built for clusters
    for chunk in (16, 32, 128):
        assert launcher.plan(8, 64, 512, chunk, BUDGETS[1]).cluster == 1
        with pytest.raises(ValueError, match="no plan"):
            launcher.plan(8, 64, 512, chunk, H100, cluster=2)
