"""Qwen2-VL-2B [arXiv:2409.12191]: 28L, d=1536, 12H GQA kv=2, ff=8960,
vocab=151936, M-RoPE (t/h/w sections), dynamic-resolution ViT STUBBED
(input_specs provides patch embeddings, dim 1176 = 14*14*3*2)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    act="swiglu",
    pos="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    frontend="vision_stub",
    frontend_dim=1176,
    vision_tokens=1024,
    citation="arXiv:2409.12191",
)
