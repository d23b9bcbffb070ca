"""Round-state constants (port of the constants of
``src/repro/core/state.py``). The block registry and the sample /
scatter primitives come with sampled rounds."""
from __future__ import annotations

# Model groups of Algorithm 1: per-modality encoders f, unimodal heads
# g, and the multimodal fusion head g_M.
CLIENT_GROUPS = ("f_A", "g_A", "f_B", "g_B", "g_M")

# Optimizer-state trees that mirror the params (and therefore carry
# the leading client axis); everything else in an opt state (the shared
# ``step`` counter) is global.
OPT_MOMENT_KEYS = ("mu", "nu", "mom")
