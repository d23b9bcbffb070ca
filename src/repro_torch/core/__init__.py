"""BlendFL core: encoders, wire codec, inference and serving (port of
``src/repro/core``)."""
