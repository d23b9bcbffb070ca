"""Task specs of the synthetic multimodal stand-ins (a copy of
``TaskSpec``, ``_TASKS`` and ``make_task`` from
``src/repro/data/synthetic.py``).

Serving needs only the shapes of a task; data generation comes with the
training slice.
"""
from __future__ import annotations

import dataclasses


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
