"""Synthetic class-conditional multimodal datasets (a numpy copy of
``src/repro/data/synthetic.py``).

Two modalities A and B are generated from a shared class-conditional
latent, so that each modality alone is predictive and the two together
predict better. Three task types mirror the paper:

- ``conditions``: 25-label multilabel (clinical conditions prediction)
- ``mortality``: binary (in-hospital mortality)
- ``smnist``: 10-class multiclass (audio-visual digits)

The same seed gives the same arrays as the reference, bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    kind: str  # 'multilabel' | 'binary' | 'multiclass'
    n_labels: int  # label dimensionality (classes for multiclass)
    seq_a: int  # modality A: time steps (EHR / audio frames)
    feat_a: int  # modality A: per-step features
    seq_b: int  # modality B: patches (CXR / image patches)
    feat_b: int  # modality B: per-patch features
    noise: float = 0.6  # generative noise of the synthetic data

    @property
    def out_dim(self) -> int:
        return self.n_labels


_TASKS = {
    "conditions": TaskSpec("conditions", "multilabel", 25, 16, 12, 16, 16,
                           noise=0.35),
    "mortality": TaskSpec("mortality", "binary", 1, 16, 12, 16, 16, noise=1.4),
    "smnist": TaskSpec("smnist", "multiclass", 10, 12, 8, 16, 12, noise=0.5),
}


def make_task(name: str) -> TaskSpec:
    return _TASKS[name]


@dataclasses.dataclass
class SyntheticMultimodal:
    """Holds arrays x_a (N, seq_a, feat_a), x_b (N, seq_b, feat_b), y."""

    spec: TaskSpec
    x_a: np.ndarray
    x_b: np.ndarray
    y: np.ndarray
    ids: np.ndarray  # global sample ids (for VFL alignment)

    def __len__(self) -> int:
        return len(self.y)

    def subset(self, idx: np.ndarray) -> "SyntheticMultimodal":
        return SyntheticMultimodal(self.spec, self.x_a[idx], self.x_b[idx], self.y[idx], self.ids[idx])


def generate(spec: TaskSpec, n: int, seed: int = 0, noise: float | None = None,
             id_offset: int = 0) -> SyntheticMultimodal:
    """Sample n multimodal instances from the class-conditional process."""
    noise = spec.noise if noise is None else noise
    rng = np.random.default_rng(seed)
    latent_dim = 24

    if spec.kind == "multiclass":
        y_int = rng.integers(0, spec.n_labels, size=n)
        y = np.eye(spec.n_labels, dtype=np.float32)[y_int]
        label_vec = y
    elif spec.kind == "binary":
        y = rng.integers(0, 2, size=(n, 1)).astype(np.float32)
        label_vec = np.concatenate([y, 1 - y], axis=1)
    else:  # multilabel
        y = (rng.random((n, spec.n_labels)) < 0.18).astype(np.float32)
        label_vec = y

    # Fixed (seed-independent of sample draw) generative projections so train /
    # val / test splits share the same world model.
    # zlib.crc32: deterministic across processes (hash() is salted)
    grng = np.random.default_rng(12345 + zlib.crc32(spec.name.encode()) % 10_000)
    w_latent = grng.normal(0, 1.0, (label_vec.shape[1], latent_dim)).astype(np.float32)
    # per-modality private latent components make fusion strictly informative
    w_a = grng.normal(0, 1.0, (latent_dim, spec.seq_a * spec.feat_a)).astype(np.float32)
    w_b = grng.normal(0, 1.0, (latent_dim, spec.seq_b * spec.feat_b)).astype(np.float32)
    split_a = grng.random(latent_dim) < 0.7  # A sees 70% of latent dims
    split_b = ~split_a | (grng.random(latent_dim) < 0.5)

    z = label_vec @ w_latent / np.sqrt(label_vec.shape[1])
    z = z + noise * rng.normal(0, 1.0, z.shape).astype(np.float32)
    z_a = np.where(split_a[None, :], z, 0.0)
    z_b = np.where(split_b[None, :], z, 0.0)

    x_a = np.tanh(z_a @ w_a / np.sqrt(latent_dim))
    x_b = np.tanh(z_b @ w_b / np.sqrt(latent_dim))
    x_a = x_a + 0.3 * noise * rng.normal(0, 1, x_a.shape)
    x_b = x_b + 0.3 * noise * rng.normal(0, 1, x_b.shape)

    ids = np.arange(id_offset, id_offset + n, dtype=np.int64)
    return SyntheticMultimodal(
        spec,
        x_a.reshape(n, spec.seq_a, spec.feat_a).astype(np.float32),
        x_b.reshape(n, spec.seq_b, spec.feat_b).astype(np.float32),
        y.astype(np.float32),
        ids,
    )


def train_val_test(spec: TaskSpec, n_train: int, n_val: int, n_test: int, seed: int = 0):
    """Generate disjoint splits from the same generative process (70/10/20 in paper)."""
    total = generate(spec, n_train + n_val + n_test, seed=seed)
    tr = total.subset(np.arange(0, n_train))
    va = total.subset(np.arange(n_train, n_train + n_val))
    te = total.subset(np.arange(n_train + n_val, n_train + n_val + n_test))
    return tr, va, te


# ------------------------------------------- non-IID cohort generation ----

def _row_labels(y: np.ndarray):
    """Collapse a label matrix to one integer class per row (binary ->
    {0,1}; multiclass/multilabel -> argmax, i.e. the dominant label)."""
    if y.shape[1] == 1:
        return (y[:, 0] > 0.5).astype(np.int64), 2
    return np.argmax(y, axis=1).astype(np.int64), y.shape[1]


def dirichlet_cohort(data: SyntheticMultimodal, n_clients: int, alpha: float,
                     seed: int = 0, power: float = 1.2, min_rows: int = 8,
                     paired_frac: float = 0.5):
    """Dirichlet label-skew cohort with power-law client sizes — the
    standard non-IID FL benchmark construction (Hsu et al. 2019; swept at
    alpha in {0.1, 0.5, 1.0} across the multimodal-FL literature).

    Each client c draws a class distribution p_c ~ Dirichlet(alpha * 1):
    alpha -> 0 gives near-single-class clients (extreme skew, maximal
    client drift), alpha -> inf recovers IID. Client sizes follow a
    shuffled power law n_c ∝ rank^-``power`` (floored at ``min_rows``),
    so the cohort mixes data-rich heads with long-tail clients. Rows are
    drawn WITHOUT replacement from per-class pools of ``data`` (a
    client's draw is trimmed when its wanted class is exhausted, then
    topped up from whatever classes still hold rows — every row is used
    at most once cohort-wide).

    Returns ``(clients, sizes)``: ``clients`` is the FederatedBatcher
    client-dict list (each row split ``paired_frac`` paired / rest
    partial, both modalities of the partial rows exposed unimodally —
    the same layout the straggler cohort uses), ``sizes`` the realized
    per-client row counts.
    """
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
    rng = np.random.default_rng(seed)
    labels, n_classes = _row_labels(data.y)
    n_rows = len(labels)

    # shuffled power-law sizes normalized onto the dataset
    raw = 1.0 / np.arange(1, n_clients + 1, dtype=np.float64) ** power
    raw = rng.permutation(raw)
    sizes = np.maximum(min_rows,
                       np.floor(raw / raw.sum() * n_rows).astype(np.int64))

    pools = [list(rng.permutation(np.nonzero(labels == k)[0]))
             for k in range(n_classes)]
    clients, realized = [], []
    for c in range(n_clients):
        p = rng.dirichlet(np.full(n_classes, float(alpha)))
        want = rng.multinomial(int(sizes[c]), p)
        take = []
        for k in range(n_classes):
            got = min(int(want[k]), len(pools[k]))
            take += [pools[k].pop() for _ in range(got)]
        # top up a trimmed draw from the fullest remaining pools so the
        # power-law size profile survives pool exhaustion
        deficit = int(sizes[c]) - len(take)
        while deficit > 0:
            k = max(range(n_classes), key=lambda j: len(pools[j]))
            if not pools[k]:
                break
            take.append(pools[k].pop())
            deficit -= 1
        idx = np.asarray(sorted(take), np.int64)
        n_pair = max(1, int(round(paired_frac * len(idx))))
        pair, part = idx[:n_pair], idx[n_pair:]
        if len(part) == 0:  # tiny client: reuse its paired rows unimodally
            part = pair
        clients.append({
            "paired_a": data.x_a[pair], "paired_b": data.x_b[pair],
            "paired_y": data.y[pair],
            "partial_a": data.x_a[part], "partial_ya": data.y[part],
            "partial_b": data.x_b[part], "partial_yb": data.y[part],
        })
        realized.append(len(idx))
    return clients, np.asarray(realized, np.int64)
