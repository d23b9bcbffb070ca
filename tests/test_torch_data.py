"""The port's numpy copies of the data, partitioning, alignment and metric
modules against the JAX package's originals, on the CPU. Both sides are
the same numpy code, so every array must be identical (exact equality,
dtypes included) and every metric equal bit for bit."""
import numpy as np
import pytest

from repro.core import partitioner as jpart
from repro.core import vfl as jvfl
from repro.data import synthetic as jsyn
from repro.metrics import classification as jmet
from repro_torch.core import partitioner as tpart
from repro_torch.core import vfl as tvfl
from repro_torch.data import synthetic as tsyn
from repro_torch.metrics import auprc, auroc


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_data(j, t):
    for f in ("x_a", "x_b", "y", "ids"):
        _same(getattr(j, f), getattr(t, f))


@pytest.mark.parametrize("task", ["conditions", "mortality", "smnist"])
def test_generate_and_splits_identical(task):
    spec = tsyn.make_task(task)
    _same_data(jsyn.generate(jsyn.make_task(task), 50, seed=3, id_offset=7),
               tsyn.generate(spec, 50, seed=3, id_offset=7))
    for j, t in zip(jsyn.train_val_test(jsyn.make_task(task), 40, 20, 10, seed=1),
                    tsyn.train_val_test(spec, 40, 20, 10, seed=1)):
        _same_data(j, t)
        assert len(t) == len(j)


def _views(cd):
    return [cd.partial_a, cd.partial_b, cd.frag_a, cd.frag_b, cd.paired_a,
            cd.paired_b]


@pytest.mark.parametrize("kw", [
    {},
    {"frac_paired": 0.4, "frac_fragmented": 0.3, "frac_partial": 0.3},
    {"frac_paired": 0.0, "frac_fragmented": 0.5, "frac_partial": 0.5},
])
def test_partition_and_overlap_identical(kw):
    tr_j = jsyn.train_val_test(jsyn.make_task("smnist"), 300, 10, 10)[0]
    tr_t = tsyn.train_val_test(tsyn.make_task("smnist"), 300, 10, 10)[0]
    jcl = jpart.partition(tr_j, 4, seed=2, **kw)
    tcl = tpart.partition(tr_t, 4, seed=2, **kw)
    assert len(jcl) == len(tcl) == 4
    for j, t in zip(jcl, tcl):
        for jv, tv in zip(_views(j), _views(t)):
            for f in ("x", "ids", "y"):
                _same(getattr(jv, f), getattr(tv, f))
        assert (j.has_a, j.has_b, j.has_paired, j.n_samples()) == \
            (t.has_a, t.has_b, t.has_paired, t.n_samples())
    _same(jpart.fragmented_overlap(jcl), tpart.fragmented_overlap(tcl))


def test_dirichlet_cohort_identical():
    data_j = jsyn.generate(jsyn.make_task("smnist"), 400, seed=4)
    data_t = tsyn.generate(tsyn.make_task("smnist"), 400, seed=4)
    jc, js = jsyn.dirichlet_cohort(data_j, 6, alpha=0.3, seed=5)
    tc, ts = tsyn.dirichlet_cohort(data_t, 6, alpha=0.3, seed=5)
    _same(js, ts)
    for j, t in zip(jc, tc):
        assert j.keys() == t.keys()
        for k in j:
            _same(j[k], t[k])
    with pytest.raises(ValueError, match="alpha"):
        tsyn.dirichlet_cohort(data_t, 6, alpha=0.0)


def test_align_by_id_identical():
    rng = np.random.default_rng(6)
    ids_a = rng.permutation(200)[:120].astype(np.int64)
    ids_b = rng.permutation(200)[:90].astype(np.int64)
    for j, t in zip(jvfl.align_by_id(ids_a, ids_b), tvfl.align_by_id(ids_a, ids_b)):
        _same(j, t)


@pytest.mark.parametrize("shape", [(200,), (200, 1), (200, 25)])
def test_auroc_auprc_identical(shape):
    rng = np.random.default_rng(7)
    y = (rng.random(shape) < 0.2).astype(np.float32)
    s = np.round(rng.random(shape), 2).astype(np.float32)  # ties included
    if len(shape) == 2 and shape[1] > 1:
        y[:, 0] = 0.0  # a label column with no positives is skipped
    for jf, tf in ((jmet.auroc, auroc), (jmet.auprc, auprc)):
        want, got = jf(y, s), tf(y, s)
        assert got == want and np.isfinite(got)
