"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``.cu`` source under ``src/repro_torch/kernels/`` compiles on its
own into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the repository root; the headers
(``.cuh``) of that directory are on its include path. The library's
name carries a hash of its source and of every header, so an edited
source or header is rebuilt and a built one is reused. Builds happen at first use, never at import;
``build_all`` starts one ``nvcc`` per source at once and waits for all.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"

# No --use_fast_math: the wire codec needs IEEE division and rintf.
# -Xptxas -v: ptxas reports each kernel's registers, stack and spills;
# the compiler's output is kept beside the library (``report``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.RLock()
_loaded: dict = {}  # source path -> ctypes.CDLL


def sources() -> list:
    """Every CUDA source of the port, in a stable order."""
    return sorted(KERNELS_DIR.rglob("*.cu"))


def headers() -> list:
    """Every CUDA header the sources may include, in a stable order."""
    return sorted(KERNELS_DIR.rglob("*.cuh"))


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.isfile("/usr/local/cuda/bin/nvcc") else None)
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels are built from "
                           "source and have no fallback")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + b"".join(h.read_bytes() for h in headers())
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(src: Path, out: Path) -> tuple:
    """Start one nvcc into a per-process temporary file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(KERNELS_DIR), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp


def _finish(proc, cmd, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial .so


def build_all() -> list:
    """Build every source whose library is missing, all nvcc processes
    at once. Returns the library paths, one per source."""
    with _lock:
        srcs = sources()
        outs = [_target(src) for src in srcs]
        jobs = []
        try:
            for src, out in zip(srcs, outs):
                if not out.exists():
                    jobs.append((*_start(src, out), out))
            for job in jobs:
                _finish(*job)
        finally:  # stop every nvcc this call started, whatever failed
            for proc, *_ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return outs


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first (with every other
    missing one) if needed."""
    src = Path(src).resolve()
    with _lock:
        if src not in _loaded:
            build_all()
            _loaded[src] = ctypes.CDLL(str(_target(src)))
        return _loaded[src]


def report(src: Path) -> str:
    """What nvcc printed when it built ``src`` (ptxas's registers, stack
    and spills of each kernel), or "" if this build directory has no
    record of it."""
    log = _target(Path(src).resolve()).with_suffix(".log")
    return log.read_text() if log.exists() else ""
