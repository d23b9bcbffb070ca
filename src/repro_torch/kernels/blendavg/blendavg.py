"""Launcher of the CUDA parameter-blend kernel (``blendavg.cu``).

``blend_params_cuda(stacked, omega)`` checks its tensors, allocates the
output, launches the kernel on the current stream and adds one to
``launches``. It takes CUDA tensors only: there is no CPU path here
(``ops.blend_params`` routes CPU tensors to ``ref.py``). The library is
built on first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).with_name("blendavg.cu")

# Kernel launches made by this process; callers reset it to 0 to count
# the launches of one run.
launches = 0

MAX_ROWS = 256  # kMaxRows in blendavg.cu: omega lives in shared memory

_ENTRY = {torch.float32: "blend_params_f32", torch.bfloat16: "blend_params_bf16"}
_fns: dict = {}


def _fn(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def blend_params_cuda(stacked: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """stacked (L, N) f32/bf16 and omega (L,) f32, both contiguous on one
    CUDA device, 1 <= L <= 256. Returns the (N,) blend in stacked's dtype."""
    global launches
    if stacked.dtype not in _ENTRY:
        raise ValueError(f"blend_params_cuda takes float32 or bfloat16, got "
                         f"{stacked.dtype}")
    if omega.dtype != torch.float32:
        raise ValueError(f"omega must be float32, got {omega.dtype}")
    if stacked.dim() != 2 or tuple(omega.shape) != (stacked.shape[0],):
        raise ValueError(f"want stacked (L, N) and omega (L,), got "
                         f"{tuple(stacked.shape)} and {tuple(omega.shape)}")
    if not (stacked.is_contiguous() and omega.is_contiguous()):
        raise ValueError("blend_params_cuda takes contiguous tensors")
    rows, n = stacked.shape
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"blend_params_cuda takes 1..{MAX_ROWS} rows, got {rows}")
    if stacked.device.type != "cuda" or omega.device != stacked.device:
        raise ValueError(f"blend_params_cuda takes CUDA tensors on one device, "
                         f"got stacked on {stacked.device}, omega on {omega.device}")
    out = torch.empty(n, dtype=stacked.dtype, device=stacked.device)
    if n == 0:
        return out
    fn = _fn(stacked.dtype)
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(stacked.data_ptr(), omega.data_ptr(), out.data_ptr(), rows, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"blendavg kernel launch failed: CUDA error {err}")
    launches += 1
    return out
