"""Hymba-1.5B [arXiv:2411.13676]: 32L, d=1600, 25H GQA kv=5 (head_dim 64),
ff=5504, vocab=32001; parallel attention + Mamba heads per block,
ssm_state=16; sliding-window attention for most layers (window 1024 global
mix in the paper; we use SWA throughout -> natively sub-quadratic)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    block_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    act="swiglu",
    pos="rope",
    attn_kind="sliding",
    window=1024,
    ssm_state=16,
    ssm_head_dim=64,
    citation="arXiv:2411.13676",
)
