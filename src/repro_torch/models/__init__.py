"""Functional layers on plain dicts of tensors (port of ``src/repro/models``)."""
