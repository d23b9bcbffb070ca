"""xLSTM-350M [arXiv:2405.04517]: 24L (12 mLSTM/sLSTM pairs), d=1024, 4H,
d_ff=0 (projections live inside the cells), vocab=50304."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    block_type="xlstm_pair",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pos="none",
    ssm_expand=2,
    citation="arXiv:2405.04517",
)
