"""Hand-written Hopper (sm_90a) kernels of the port.

Each kernel ships as a subpackage, mirroring ``src/repro/kernels``:
``<name>/<name>.cu`` (the CUDA source), ``<name>/<name>.py`` (the
launcher: builds the source on first use through ``_build.py``, checks
its tensors, launches on the current stream and counts its launches),
``<name>/ops.py`` (the public wrapper) and ``<name>/ref.py`` (the plain
PyTorch version).

A wrapper launches its kernel for a CUDA tensor and uses ``ref.py`` only
for a tensor that lies on the CPU; nothing is built or imported from
the CUDA toolchain when a module is imported.
"""
from __future__ import annotations

import contextlib

import torch


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |x| (0 where x is 0): the slack a bf16 result may
    need when two f32 computations of it round to neighbouring values."""
    big = x.float().abs()
    _, e = torch.frexp(big)  # big = m * 2^e, 0.5 <= m < 1
    ulp = torch.ldexp(torch.ones_like(big), e - 8)  # 8 significand bits
    return torch.where(big > 0, ulp, torch.zeros_like(ulp))


def on_device(dev: torch.device):
    """A context that makes CUDA device ``dev`` current for a launch,
    entered only where another device is current: ``torch.cuda.device``
    costs host time on every call (chip_smoke.py phase 6 times it)."""
    # torch.cuda.current_device() would run its lazy-init check each call;
    # a caller holds a CUDA tensor, so CUDA is initialised already
    if dev.index is None or dev.index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
