"""Checkpointing: a tree of tensors <-> ``.npz`` + JSON manifest (port of
``src/repro/checkpoint/store.py``).

Layout:  <dir>/step_<N>/arrays.npz     flattened leaves keyed by path string
         <dir>/step_<N>/manifest.json  keys + shapes/dtypes + metadata

Keys are the ``/``-joined leaf paths of the saved tree (dict keys, list
indices), e.g. ``global_models/f_A/hidden/0/w`` or ``opt/step``: the
reference's keys, so that each package restores the other's files.

Writes are atomic: both files land in a ``step_<N>.tmp`` staging
directory that is renamed into place only once complete (a stale
``.tmp`` from a crashed writer is swept by the next save of that step).
An overwrite moves the old step aside as ``step_<N>.old``, renames the
new one in and only then deletes the old, so a complete copy of the
step is findable at every instant; ``.old`` is a readable fallback and
``.tmp`` is never read.

A restore validates every leaf against the target tree's shapes AND
dtypes: a kind mismatch (an int32 ``last_round`` leaf restored into a
float tree) raises instead of reinterpreting; a width difference of one
kind (f64 -> f32) is cast to the target's dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.common.tree import tree_unflatten


def _flatten_with_paths(tree, prefix: str = "", items: dict | None = None) -> dict:
    """``{path: tensor}`` in ``tree_leaves`` order. Raises on a duplicate
    key: a nested {"a": {"b": ...}} collides with a literal "a/b" key,
    and one leaf would silently win on save."""
    items = {} if items is None else items
    if isinstance(tree, dict):
        children = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        children = ((str(i), v) for i, v in enumerate(tree))
    else:
        if prefix in items:
            raise ValueError(f"duplicate flattened checkpoint key {prefix!r}")
        items[prefix] = tree
        return items
    for k, v in children:
        _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k, items)
    return items


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None = None) -> str:
    """Write ``tree`` (nested dicts / lists of tensors or arrays) as step
    ``step`` under ``ckpt_dir``; returns the step's directory."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    if os.path.isdir(tmp):  # stale staging dir from a crashed writer
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **items)
    manifest = {
        "step": step,
        "keys": sorted(items.keys()),
        "shapes": {k: list(v.shape) for k, v in items.items()},
        "dtypes": {k: str(v.dtype) for k, v in items.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    old = out + ".old"
    if os.path.isdir(out):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(out, old)
    os.rename(tmp, out)
    shutil.rmtree(old, ignore_errors=True)
    return out


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


def restore_checkpoint(ckpt_dir: str, target_tree, step: int | None = None,
                       device=None):
    """A tree of ``target_tree``'s structure holding the step's values
    (the latest step when ``step`` is None). Each leaf is checked against
    the target's shape and dtype kind, cast to the target's dtype, and
    placed on ``device`` (the target leaf's own device when None), in
    fresh storage."""
    path = _step_dir(ckpt_dir, _resolve(ckpt_dir, step))
    targets = _flatten_with_paths(target_tree)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, want in targets.items():
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: {arr.shape} vs {tuple(want.shape)}")
            want_np = np.dtype(str(want.dtype).replace("torch.", ""))
            if arr.dtype != want_np:
                if arr.dtype.kind != want_np.kind:
                    raise ValueError(
                        f"dtype mismatch for {key!r}: checkpoint {arr.dtype} "
                        f"vs target {want_np} (different kinds, refusing to cast)")
                arr = arr.astype(want_np)
            dev = torch.device(want.device if device is None else device)
            host = torch.from_numpy(arr)
            out.append(host.clone() if dev.type == "cpu" else host.to(dev))
    return tree_unflatten(target_tree, out)
