"""Checkpoint store (port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.store import (latest_step, load_arrays,
                                          read_manifest, restore_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest", "load_arrays"]
