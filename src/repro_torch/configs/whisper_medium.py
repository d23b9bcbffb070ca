"""Whisper-medium [arXiv:2212.04356]: 24L enc + 24L dec, d=1024, 16H,
ff=4096, vocab=51865. Conv/mel frontend STUBBED (input_specs provides frame
embeddings, dim 80 mel bins); learned positions; encoder-decoder."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    block_type="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    pos="learned",
    frontend="audio_stub",
    frontend_dim=80,
    citation="arXiv:2212.04356",
)
