"""Aggregation strategies (port of ``StrategyConfig`` and
``make_strategy`` from ``src/repro/core/aggregate.py``).

The port runs the two weighting strategies of the paper's comparison:

    blendavg   Eq. 9-10 validation-improvement omegas (score-based)
    fedavg     data-volume weights

FedProx, SCAFFOLD, the robust reducers and the server-side optimizers
are not ported yet: naming one raises ``NotImplementedError`` (ROADMAP.md,
modules to port, item 9). The configuration holds only what selects a
path (the reference's knobs of the unported strategies, such as
``n_malicious`` or the server optimizer's rates, come with them).
"""
from __future__ import annotations

import dataclasses

ROBUST = ("median", "trimmed_mean", "krum")
STRATEGIES = ("blendavg", "fedavg", "scaffold", "fedprox") + ROBUST
SERVER_OPTS = ("none", "adam", "momentum")
PORTED = ("blendavg", "fedavg")


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Static aggregation-strategy configuration."""

    name: str = "blendavg"  # one of STRATEGIES
    fedprox_mu: float = 0.0
    server_opt: str = "none"  # one of SERVER_OPTS

    def __post_init__(self):
        if self.name not in STRATEGIES:
            raise ValueError(f"strategy {self.name!r} not in {STRATEGIES}")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(
                f"server_opt {self.server_opt!r} not in {SERVER_OPTS}")
        if self.fedprox_mu < 0:
            raise ValueError(f"fedprox_mu must be >= 0, got {self.fedprox_mu}")
        if self.fedprox_mu and self.name not in ("fedprox",):
            raise ValueError("fedprox_mu > 0 requires strategy 'fedprox' "
                             f"(got {self.name!r})")
        if self.name not in PORTED or self.server_opt != "none":
            raise NotImplementedError(
                f"strategy {self.name!r} with server_opt {self.server_opt!r} "
                f"is not ported yet (ROADMAP.md, modules to port, item 9); "
                f"the port runs {PORTED} with server_opt 'none'")

    @property
    def score_based(self) -> bool:
        """Aggregation weights come from validation scores (Eq. 9-10)."""
        return self.name == "blendavg"


def make_strategy(name: str = "blendavg", fedprox_mu: float = 0.0,
                  server_opt: str = "none") -> StrategyConfig:
    return StrategyConfig(name=name, fedprox_mu=fedprox_mu,
                          server_opt=server_opt)
