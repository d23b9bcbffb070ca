"""StarCoder2-7B [arXiv:2402.19173]: 32L, d=4608, 36H GQA kv=4, ff=18432,
vocab=49152, RoPE, GELU MLP (pre-norm, learned-abs replaced by RoPE per card)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    act="gelu",
    pos="rope",
    qkv_bias=True,
    citation="arXiv:2402.19173",
)
