"""Data fragmentation across federated clients (paper §III-A; a numpy
copy of ``src/repro/core/partitioner.py``).

Every global sample is assigned one of the paper's three patient types:

- ``paired``     both modalities collected at ONE client,
- ``fragmented`` modality A at one client, modality B at a DIFFERENT client
                 (same global sample id — the VFL overlap set),
- ``partial``    exactly one modality exists anywhere (never collected).

``partition`` returns one :class:`ClientData` per client, each holding the
per-modality views plus the id arrays the server uses for VFL alignment.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import SyntheticMultimodal


@dataclasses.dataclass
class ModalView:
    """One client's view of one modality: features + global ids + labels."""

    x: np.ndarray  # (n, seq, feat)
    ids: np.ndarray  # (n,) global sample ids
    y: np.ndarray  # (n, out_dim)

    def __len__(self) -> int:
        return len(self.ids)

    @staticmethod
    def empty(seq: int, feat: int, out_dim: int) -> "ModalView":
        return ModalView(
            np.zeros((0, seq, feat), np.float32),
            np.zeros((0,), np.int64),
            np.zeros((0, out_dim), np.float32),
        )

    @staticmethod
    def concat(views: list["ModalView"]) -> "ModalView":
        return ModalView(
            np.concatenate([v.x for v in views]),
            np.concatenate([v.ids for v in views]),
            np.concatenate([v.y for v in views]),
        )


@dataclasses.dataclass
class ClientData:
    """Local dataset of one client, split by patient type (paper Eq. 1-2)."""

    partial_a: ModalView
    partial_b: ModalView
    frag_a: ModalView
    frag_b: ModalView
    paired_a: ModalView  # paired_a.ids == paired_b.ids row-for-row
    paired_b: ModalView

    @property
    def has_a(self) -> bool:
        return len(self.partial_a) + len(self.frag_a) + len(self.paired_a) > 0

    @property
    def has_b(self) -> bool:
        return len(self.partial_b) + len(self.frag_b) + len(self.paired_b) > 0

    @property
    def has_paired(self) -> bool:
        return len(self.paired_a) > 0

    def all_a(self) -> ModalView:
        """Every modality-A sample this client holds (for unimodal training)."""
        return ModalView.concat([self.partial_a, self.frag_a, self.paired_a])

    def all_b(self) -> ModalView:
        return ModalView.concat([self.partial_b, self.frag_b, self.paired_b])

    def n_samples(self) -> int:
        return (len(self.partial_a) + len(self.partial_b) + len(self.frag_a)
                + len(self.frag_b) + len(self.paired_a))


def partition(
    data: SyntheticMultimodal,
    n_clients: int,
    *,
    frac_paired: float = 0.4,
    frac_fragmented: float = 0.3,
    frac_partial: float = 0.3,
    dirichlet_alpha: float | None = None,
    seed: int = 0,
) -> list[ClientData]:
    """Assign each global sample a patient type and client placement.

    dirichlet_alpha: if set, client placement is label-skewed — each
    class's samples are distributed over clients with probabilities drawn
    from Dirichlet(alpha) (standard non-IID FL protocol; lower alpha =
    more heterogeneity). None = uniform placement.
    """
    assert abs(frac_paired + frac_fragmented + frac_partial - 1.0) < 1e-6
    rng = np.random.default_rng(seed)
    n = len(data)
    spec = data.spec

    if dirichlet_alpha is not None and n_clients > 1:
        y = data.y
        cls = np.argmax(y, axis=1) if y.ndim == 2 and y.shape[1] > 1 else \
            y.ravel().astype(int)
        probs = rng.dirichlet([dirichlet_alpha] * n_clients,
                              size=int(cls.max()) + 1)
        client_of = np.array([rng.choice(n_clients, p=probs[c]) for c in cls])
    else:
        client_of = rng.integers(n_clients, size=n)

    perm = rng.permutation(n)
    n_pair = int(round(frac_paired * n))
    n_frag = int(round(frac_fragmented * n))
    idx_pair = perm[:n_pair]
    idx_frag = perm[n_pair : n_pair + n_frag]
    idx_part = perm[n_pair + n_frag :]

    buckets: list[dict[str, list]] = [
        {k: [] for k in ("partial_a", "partial_b", "frag_a", "frag_b", "paired")}
        for _ in range(n_clients)
    ]

    for i in idx_pair:
        buckets[client_of[i]]["paired"].append(i)
    for i in idx_frag:
        ca = int(client_of[i])
        cb = (ca + 1 + rng.integers(n_clients - 1)) % n_clients if n_clients > 1 else ca
        buckets[ca]["frag_a"].append(i)
        buckets[cb]["frag_b"].append(i)
    for i in idx_part:
        c = client_of[i]
        side = "partial_a" if rng.random() < 0.5 else "partial_b"
        buckets[c][side].append(i)

    def view_a(idx: list) -> ModalView:
        if not idx:
            return ModalView.empty(spec.seq_a, spec.feat_a, spec.out_dim)
        sel = np.asarray(idx)
        return ModalView(data.x_a[sel], data.ids[sel], data.y[sel])

    def view_b(idx: list) -> ModalView:
        if not idx:
            return ModalView.empty(spec.seq_b, spec.feat_b, spec.out_dim)
        sel = np.asarray(idx)
        return ModalView(data.x_b[sel], data.ids[sel], data.y[sel])

    clients = []
    for b in buckets:
        clients.append(
            ClientData(
                partial_a=view_a(b["partial_a"]),
                partial_b=view_b(b["partial_b"]),
                frag_a=view_a(b["frag_a"]),
                frag_b=view_b(b["frag_b"]),
                paired_a=view_a(b["paired"]),
                paired_b=view_b(b["paired"]),
            )
        )
    return clients


def fragmented_overlap(clients: list[ClientData]) -> np.ndarray:
    """Global ids present as modality A at one client AND modality B at
    another — the VFL-trainable overlap set (server-side alignment)."""
    ids_a = np.concatenate([c.frag_a.ids for c in clients]) if clients else np.zeros(0, np.int64)
    ids_b = np.concatenate([c.frag_b.ids for c in clients]) if clients else np.zeros(0, np.int64)
    return np.intersect1d(ids_a, ids_b)
