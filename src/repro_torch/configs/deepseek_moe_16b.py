"""DeepSeekMoE-16B [arXiv:2401.06066]: 28L, d=2048, 16H MHA (kv=16),
expert ff=1408, vocab=102400; fine-grained MoE: 64 routed experts top-6
+ 2 shared experts."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    act="swiglu",
    pos="rope",
    citation="arXiv:2401.06066",
)
