"""Nemotron-4 15B [arXiv:2402.16819]: 32L, d=6144, 48H GQA kv=8, ff=24576,
vocab=256000, squared-ReLU MLP, RoPE."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    act="relu2",
    pos="rope",
    citation="arXiv:2402.16819",
)
