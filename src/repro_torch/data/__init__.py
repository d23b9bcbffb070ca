"""Synthetic multimodal tasks and their data (port of ``src/repro/data``)."""
