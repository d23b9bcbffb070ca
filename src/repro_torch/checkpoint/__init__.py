"""Read side of the checkpoint layout (port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.store import latest_step, load_arrays, read_manifest

__all__ = ["latest_step", "read_manifest", "load_arrays"]
