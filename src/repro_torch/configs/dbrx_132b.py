"""DBRX-132B [hf:databricks/dbrx-base]: 40L, d=6144, 48H GQA kv=8,
expert ff=10752, vocab=100352; fine-grained MoE: 16 experts top-4."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    n_shared_experts=0,
    top_k=4,
    act="swiglu",
    pos="rope",
    citation="hf:databricks/dbrx-base",
)
