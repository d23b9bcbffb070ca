"""Fused wire-codec round-trip kernel (port of ``src/repro/kernels/wire_codec``)."""
