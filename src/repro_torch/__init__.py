"""PyTorch/CUDA port of the BlendFL system (``src/repro`` is the JAX
reference it is held against).

The port mirrors the reference's layout and names module for module
(``repro_torch/core/inference.py`` for ``repro/core/inference.py``, and
so on). Model parameters are plain nested dicts of tensors keyed like
the JAX pytrees; the functions on them keep the reference's names.

Devices are explicit: every entry point takes ``device=`` and, given
none, runs on CUDA — it raises when CUDA is missing and never drops to
the CPU by itself. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, or CUDA
    when it is None. Raises ``RuntimeError`` if CUDA is asked for (or
    defaulted to) and this process has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU "
            "(the port never falls back to it on its own)")
    return dev
