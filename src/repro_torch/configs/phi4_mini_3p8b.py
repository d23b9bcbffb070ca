"""Phi-4-mini 3.8B [arXiv:2412.08905]: 32L, d=3072, 24H GQA kv=8, ff=8192,
vocab=200064, RoPE + SwiGLU."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="swiglu",
    pos="rope",
    citation="arXiv:2412.08905",
)
