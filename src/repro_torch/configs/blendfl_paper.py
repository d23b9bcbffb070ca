"""The paper's own architecture family (MedFuse-style, [26] in the paper):
an LSTM-family encoder for EHR time-series + a vision encoder for CXR,
fused by a linear multimodal head. Our TPU-native re-expression uses an
xLSTM-pair stack as the recurrent EHR encoder backbone (the modern JAX
equivalent of the paper's 2-layer LSTM) — the BlendFL federation layer in
repro.core instantiates small per-modality encoders directly, see
repro/core/encoders.py. This config exists so the paper's backbone is also
dry-runnable like the assigned archs."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="blendfl-paper",
    family="ssm",
    block_type="xlstm_pair",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    pos="none",
    citation="BlendFL (this paper), MedFuse arch [26]",
)
