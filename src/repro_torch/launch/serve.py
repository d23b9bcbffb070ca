"""Deprecated module path — the LM prefill/decode demo moved to
``repro_torch.launch.serve_lm`` (port of ``src/repro/launch/serve.py``).

The ``serve`` name was misleading: this module never served the paper's
federated models, it demos backbone prefill + batched decode. BlendFL
serving (the decentralized-inference engine over trained blended
models) is ``repro_torch.launch.serve_federated``.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.launch.serve moved to repro_torch.launch.serve_lm (LM "
    "prefill/decode demo); the federated serving CLI is "
    "repro_torch.launch.serve_federated",
    DeprecationWarning, stacklevel=2)

from repro_torch.launch.serve_lm import main  # noqa: E402,F401

if __name__ == "__main__":
    main()
