"""Tree helpers shared by the port (port of ``src/repro/common``)."""
