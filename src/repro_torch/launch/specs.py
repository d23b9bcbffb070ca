"""Assigned input shapes -> one-card entries and meta-device specs (the
port's counterpart of ``src/repro/launch/specs.py``).

Each (arch, shape) pair resolves, as in the reference, to:
  - a config VARIANT: the production numerics (bf16 compute, f32
    parameters, ``remat`` for training); long_500k swaps full attention
    for the sliding-window variant on quadratic archs;
  - an entry function (a train step, prefill, decode);
  - argument specs: tensors on the ``meta`` device, which hold shapes
    and dtypes and no storage (the counterpart of ``jax.eval_shape``).

The reference lowers each entry on a 16 x 16 (data, model) mesh
(``src/repro/launch/mesh.py``). One card has no mesh: what the port
keeps of it is the share one card holds, ONE DATA SHARD'S ROWS WITH THE
WHOLE MODEL (``one_card_shape``): prefill_32k 2 x 32768, decode_32k 8
rows against a 32768-slot cache, long_500k 1 row (the reference does
not shard a batch under 16), train_4k 16 x 4096. ``use_fsdp`` /
``FSDP_MIN_PARAMS`` and the ``in_shardings`` functions place arrays on
that mesh and have no counterpart here (ROADMAP item 16).

``applicability(arch, shape)`` encodes the reference's skip table:
  whisper-medium x long_500k        SKIP (enc-dec, no sub-quadratic form)
  dense/moe/vlm  x long_500k        swa variant (beyond-paper, marked)
  ssm/hybrid     x long_500k        native
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.models import backbone as bb
from repro_torch.models.config import ArchConfig

ENC_FRAMES = 1500  # whisper encoder frames (30 s clip)
DATA_SHARDS = 16  # the reference's production mesh: 16 data x 16 model
MULTI_POD_DATA_SHARDS = 32  # its 2 x 16 x 16 multi-pod mesh


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicability(cfg: ArchConfig, shape: ShapeSpec) -> str:
    """'native' | 'swa' (sliding-window variant) | 'skip'."""
    if shape.name != "long_500k":
        return "native"
    if cfg.is_encdec:
        return "skip"  # whisper: no sensible sub-quadratic variant
    if cfg.subquadratic:
        return "native"  # ssm / hybrid / already-sliding archs
    return "swa"  # dense / moe / vlm: beyond-paper sliding-window variant


def one_card_config(arch: str, shape: ShapeSpec) -> ArchConfig | None:
    """The reference's ``dryrun_config`` without the mesh: the config
    variant for this (arch, shape), None for a skip.

    Production numerics as the reference sets them: bf16 compute, f32
    parameters, ``remat`` for training. ``moe_groups``: the reference
    groups its MoE dispatch one group per data shard (16 groups over 16
    shards) wherever it shards the batch (batch >= 16), and the rows one
    card holds are one data shard's, which form one group. So 1 where
    the reference groups, 0 (the flat dispatch) where it does not.
    ``act_shard`` stays empty: one card has no mesh axis to pin
    activations to."""
    cfg = get_config(arch)
    app = applicability(cfg, shape)
    if app == "skip":
        return None
    if app == "swa":
        cfg = cfg.replace(attn_kind="sliding", window=4096)
    groups = 1 if (cfg.n_experts and shape.batch >= 16) else 0
    return cfg.replace(compute_dtype="bfloat16", moe_groups=groups,
                       remat=(shape.kind == "train"))


def one_card_shape(shape: ShapeSpec, multi_pod: bool = False) -> ShapeSpec:
    """The batch one data shard holds: batch / 16 (32 on the multi-pod
    mesh), at least 1."""
    shards = MULTI_POD_DATA_SHARDS if multi_pod else DATA_SHARDS
    return dataclasses.replace(shape, batch=max(1, shape.batch // shards))


#: per-(arch, shape) grad-accumulation overrides, as the reference sets
#: them: recurrent stacks (xlstm) pay per-time-step weight re-reads in
#: every microbatch's scan and have small activations, so one big
#: microbatch amortizes the weight traffic.
MICROBATCH_OVERRIDES = {
    ("xlstm_350m", "train_4k"): 1,
    ("hymba_1p5b", "train_4k"): 2,
}


def default_microbatches(arch: str, shape) -> int:
    name = shape.name if hasattr(shape, "name") else shape
    return MICROBATCH_OVERRIDES.get((arch, name), 8)


# ------------------------------------------------------------ input specs --

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.batch, shape.seq
    i32, f32 = torch.int32, torch.float32
    if cfg.frontend == "vision_stub":
        s_text = s - cfg.vision_tokens
        return {"patches": _meta((b, cfg.vision_tokens, cfg.frontend_dim), f32),
                "tokens": _meta((b, s_text), i32),
                "labels": _meta((b, s_text), i32)}
    if cfg.is_encdec:
        return {"frames": _meta((b, ENC_FRAMES, cfg.frontend_dim), f32),
                "tokens": _meta((b, s), i32),
                "labels": _meta((b, s), i32)}
    return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_specs(cfg: ArchConfig, shape: ShapeSpec,
                 cache_dtype=torch.bfloat16) -> dict:
    b = shape.batch
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": bb.init_cache(cfg, b, shape.seq, cache_dtype,
                                   enc_len=ENC_FRAMES, device="meta"),
            "index": _meta((), torch.int32)}


def params_specs(cfg: ArchConfig) -> dict:
    return bb.init_params(None, cfg, device="meta")


# ----------------------------------------------------------- entry points --

def make_entry(cfg: ArchConfig, shape: ShapeSpec, microbatches: int = 8):
    """Returns (fn, args specs tuple): ``fn`` runs on the device of the
    tensors it is given; the specs are meta tensors of its arguments.

    train: fn(params, opt_state, batch) -> (params, opt_state, metrics),
    the reference's step: ``make_train_step`` with ``adamw(1e-4)`` over
    ``microbatches`` microbatches (``default_microbatches`` gives the
    reference's count of an (arch, shape)); it steps the parameters and
    state it is given in place (the step owns them). prefill: fn(params,
    batch) -> (logits, cache, next index), with a ``shape.seq``-slot bf16
    cache.
    decode: fn(params, tokens, cache, index) -> (logits, cache), the step
    writing into ``cache``."""
    p_specs = params_specs(cfg)
    if shape.kind == "train":
        opt = optim.adamw(1e-4)
        return bb.make_train_step(cfg, opt, microbatches=microbatches), (
            p_specs, opt.init(p_specs), train_batch_specs(cfg, shape))
    if shape.kind == "prefill":
        def fn(params, batch):
            return bb.prefill(params, cfg, batch, max_len=shape.seq,
                              cache_dtype=torch.bfloat16)

        return fn, (p_specs, prefill_batch_specs(cfg, shape))

    d_specs = decode_specs(cfg, shape)

    def fn(params, tokens, cache, index):
        return bb.decode_step(params, cfg, tokens, cache, index)

    return fn, (p_specs, d_specs["tokens"], d_specs["cache"], d_specs["index"])


# ------------------------------------------------- blendfl federated round --

def blendfl_spec(n_clients: int = 16, n_sampled: int = 0):
    """The reference's widest BlendFL entry (``make_blendfl_entry``'s
    ``ShardedFedSpec``)."""
    from repro_torch.core import federation_sharded as fs

    return fs.ShardedFedSpec(n_clients=n_clients, d_hidden=1024, n_layers=4,
                             seq_a=64, feat_a=128, seq_b=64, feat_b=128,
                             out_dim=25, n_partial=512, n_frag=512,
                             n_paired=512, n_val=2048, n_val_score=512,
                             n_sampled=n_sampled)


def make_blendfl_entry(n_clients: int = 16, n_sampled: int = 0):
    """The paper's own technique as an entry: one BlendFL round (3
    training phases + the BlendAvg blend) of ``core.federation_sharded``
    over stacked clients on one card. ``n_sampled`` > 0 gives the K-of-C
    sampled async round. Returns (round_fn, (state specs, batch specs),
    spec), the specs meta tensors."""
    from repro_torch.core import federation_sharded as fs

    spec = blendfl_spec(n_clients, n_sampled)
    state = fs.init_round_state(None, spec, device="meta")
    batch = {k: _meta(shape, getattr(torch, dtype.name))
             for k, (shape, dtype) in fs.batch_specs(spec).items()}
    return fs.make_blendfl_round(spec), (state, batch), spec
