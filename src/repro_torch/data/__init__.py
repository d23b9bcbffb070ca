"""Task specs of the synthetic multimodal tasks (port of ``src/repro/data``)."""
