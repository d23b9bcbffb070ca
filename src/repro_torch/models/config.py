"""Architecture configuration schema (port of ``src/repro/models/config.py``).

One ``ArchConfig`` covers every family of the reference (dense / moe /
ssm / hybrid / vlm / audio), with the same fields, defaults and derived
properties; ``pdtype`` and ``cdtype`` are torch dtypes here. The port
runs the ``xlstm_pair`` block type so far (``models/backbone.py``).
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # block structure
    block_type: str = "attn"  # attn | xlstm_pair | hybrid | encdec
    act: str = "swiglu"  # swiglu | gelu | relu2
    pos: str = "rope"  # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)  # head_dim/2 split among (t, h, w)

    # attention
    attn_kind: str = "full"  # full | sliding
    window: int = 4096
    attn_logit_softcap: float = 0.0
    qkv_bias: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM / xLSTM / hybrid
    ssm_state: int = 0  # mamba state size N
    ssm_head_dim: int = 64  # mamba head dim P
    ssm_expand: int = 2  # mLSTM up-projection factor

    # encoder-decoder (audio family)
    n_enc_layers: int = 0

    # modality frontend (a stub in the reference)
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_dim: int = 0
    vision_tokens: int = 1024

    # MoE dispatch grouping; 0 = flat (single-device) path
    moe_groups: int = 0

    # mesh axes the activation batch dim is sharded over (the reference's
    # SPMD launcher); empty on one device
    act_shard: tuple = ()

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    citation: str = ""

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def is_encdec(self) -> bool:
        return self.block_type == "encdec"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with O(1)-per-token state at 500k context?"""
        return self.block_type in ("xlstm_pair", "hybrid") or self.attn_kind == "sliding"

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference computes it."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        qkv_out = d * (self.n_heads + 2 * self.n_kv_heads) * self.hd + self.n_heads * self.hd * d
        if self.act == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.n_experts:
            mlp_total = self.n_experts * mlp + self.n_shared_experts * mlp
        else:
            mlp_total = mlp
        per_layer = qkv_out + mlp_total
        if self.block_type == "xlstm_pair":
            e = self.ssm_expand
            # mLSTM: up(2ed) + qkv on ed + down; sLSTM: 4 gates + recurrent + GLU
            mlstm = d * (2 * e * d) + 3 * (e * d) * (e * d) // max(self.n_heads, 1) + e * d * d
            slstm = 8 * d * d + int(2 * d * (4 * d / 3))
            per_layer = (mlstm + slstm) / 2  # per single layer (pairs hold both)
        if self.block_type == "hybrid":
            n = self.ssm_state
            p = self.ssm_head_dim
            h = self.n_heads
            mamba = d * (2 * h * p) + h * p * (2 * n + 1) + h * p * d
            per_layer = qkv_out + mlp + mamba
        layers = self.n_layers + self.n_enc_layers
        return int(emb + layers * per_layer)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.n_experts:
            return self.n_params
        d, ff = self.d_model, self.d_ff
        mlp = (3 if self.act == "swiglu" else 2) * d * ff
        inactive = (self.n_experts - self.top_k) * mlp * self.n_layers
        return int(self.n_params - inactive)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        hd = max(d // n_heads, 8)
        kv = max(1, min(self.n_kv_heads, n_heads))
        # keep GQA structure: kv must divide heads
        while n_heads % kv:
            kv -= 1
        # rescale M-RoPE sections to the reduced head_dim (sum must equal hd/2)
        half = hd // 2
        tot = sum(self.mrope_sections)
        secs = [max(1, (s * half) // tot) for s in self.mrope_sections]
        secs[0] += half - sum(secs)
        return self.replace(
            mrope_sections=tuple(secs),
            n_layers=2,
            n_enc_layers=2 if self.n_enc_layers else 0,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            ssm_head_dim=min(self.ssm_head_dim, 16),
            window=min(self.window, 64),
            vision_tokens=8,
            frontend_dim=min(self.frontend_dim, 32) if self.frontend_dim else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )
