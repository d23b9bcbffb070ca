"""Vertical (split) training for fragmented data — the server-side
alignment (port of ``align_by_id`` in ``src/repro/core/vfl.py``).

The split exchange itself is one joint forward/backward in
``core/engine.py::vfl_step``; the reference's upload/download helpers
come with a later slice.
"""
from __future__ import annotations

import numpy as np


def align_by_id(ids_a: np.ndarray, ids_b: np.ndarray):
    """Server-side private-set alignment: row indices (ia, ib) such that
    ids_a[ia] == ids_b[ib], each id used once, sorted by id."""
    common, ia, ib = np.intersect1d(ids_a, ids_b, return_indices=True)
    return common, ia, ib
