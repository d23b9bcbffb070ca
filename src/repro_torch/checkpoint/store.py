"""Checkpoint reading: the ``.npz`` + JSON manifest layout (port of the
read side of ``src/repro/checkpoint/store.py``).

Layout:  <dir>/step_<N>/arrays.npz     flattened leaves keyed by path string
         <dir>/step_<N>/manifest.json  keys + shapes/dtypes + metadata

Keys are the ``/``-joined leaf paths of the saved tree (dict keys, list
indices), e.g. ``global_models/f_A/hidden/0/w``. A ``step_<N>.old``
directory (the complete previous copy a crashed overwrite moved aside)
is a readable fallback; ``.tmp`` staging directories are never read.
Writing checkpoints comes with the resumable-driver slice.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np


def _step_dir(ckpt_dir: str, step: int) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.isdir(path):
        return path
    if os.path.isdir(path + ".old"):
        return path + ".old"
    raise FileNotFoundError(f"no checkpoint for step {step} under {ckpt_dir}")


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = {
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)(\.old)?", d))
    }
    return max(steps) if steps else None


def _resolve(ckpt_dir: str, step: int | None) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return step


def read_manifest(ckpt_dir: str, step: int | None = None) -> dict:
    """The full manifest of a step (keys/shapes/dtypes/metadata) without
    loading any arrays."""
    path = _step_dir(ckpt_dir, _resolve(ckpt_dir, step))
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_arrays(ckpt_dir: str, step: int | None = None,
                prefixes: tuple = ()) -> dict:
    """The flat ``/``-keyed numpy dict of a step's ``arrays.npz``, only
    the keys under one of ``prefixes`` (top-level names such as
    ``"global_models"``) when any are given."""
    path = _step_dir(ckpt_dir, _resolve(ckpt_dir, step))
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k: data[k] for k in data.files
                if not prefixes or any(k == p or k.startswith(p + "/")
                                       for p in prefixes)}
