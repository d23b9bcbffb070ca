"""BlendAvg parameter-blend kernel (port of ``src/repro/kernels/blendavg``)."""
