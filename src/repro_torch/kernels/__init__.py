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
