"""Modality frontends (port of ``src/repro/models/frontends.py``): stubs,
as in the reference.

The audio (mel-spectrogram + conv codec) and vision (ViT/SigLIP) feature
extractors are not implemented; callers feed precomputed frame / patch
embeddings of the right shape, and these projectors map them into the
backbone's d_model.
"""
from __future__ import annotations

from repro_torch.models.common import dense, dense_init


def frontend_init(gen, cfg, dtype, *, device):
    if cfg.frontend == "none":
        return {}
    return {"proj": dense_init(gen, cfg.frontend_dim, cfg.d_model, dtype,
                               device=device, bias=True)}


def frontend_apply(p, cfg, feats, compute_dtype):
    """feats: (B, S, frontend_dim) frame/patch embeddings -> (B, S, d_model)."""
    del cfg
    return dense(p["proj"], feats.to(compute_dtype))
