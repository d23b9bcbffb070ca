"""The one-card hardware model (the port's counterpart of
``src/repro/launch/roofline.py``).

The reference models a TPU v5e pod and reads its terms from compiled
HLO: a compute term (HLO FLOPs over the chips' peak), a memory term
(HLO bytes over their HBM rate) and a collective term (bytes parsed out
of the post-SPMD HLO over the links). One H100 has no collective term,
and PyTorch has no HLO to read, so the port's terms come from the model:

    compute term = (weight products + attention's) / the peak rate of
                   the compute dtype
    memory term  = the bytes read and written once (parameters, cache,
                   batch, outputs; what ``launch/dryrun.py`` counts) /
                   the HBM rate

``model_flops`` is the reference's (2·N·D and its kin). It counts every
parameter for every token, the embedding tables and the head included,
which a prefill (logits of the last token only) does not compute, and
it leaves out the products of attention over the keys; on a model cut
to a few layers its count can exceed the work. The bound takes the work
the call must do instead: ``matmul_flops`` (2 FLOPs a weight a row the
weight is applied to: the layers' weights, experts at top_k / E, each
token's rows, the encoder's frames, the head's logit rows) plus
``attention_flops`` (q k^T and p v, 4 FLOPs a query a visible key a head
dim). What neither counts (norms, biases, the recurrent scans' own
products) only lowers the bound. The bound is the larger of the two
terms, and the term that sets it is the bottleneck.

The peak rates are the H100 SXM's data-sheet numbers that
``chip_smoke.py`` holds every kernel's bound to: 3.35 TB/s of HBM; 67
TFLOP/s of f32 outside the tensor cores, 495 of TF32 (three products a
3xTF32 step, so 495 / 3 for f32 done that way) and 989 of bf16 on the
tensor cores (dense).
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
BF16_OPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores (dense)
CARD_BYTES = 80e9  # one H100's device memory


def hbm_bytes_per_s(name: str) -> float:
    """Device memory rate of the card by its name (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return HBM_BYTES_PER_S  # H100 SXM


def peak_ops_per_s(dtype: torch.dtype) -> float:
    """The peak rate of the engine that computes a model's products in
    ``dtype``: the tensor cores for bf16, SIMT f32 otherwise (the port
    runs its f32 GEMMs with TF32 off)."""
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def model_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N_active·B (decode, per token),
    as the reference counts them."""
    n_active = cfg.n_active_params
    if shape_kind == "train":
        return 6.0 * n_active * batch * seq
    if shape_kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch  # one token per sequence


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    else:
        yield path, tree


def matmul_flops(cfg, params, shape_kind: str, batch: int, seq: int,
                 enc_len: int = 1500) -> float:
    """The weight products a call must do, from its parameters (meta
    tensors will do): 2 FLOPs a weight of each stacked layer (its
    matrices: leaves of 3 dims or more) a row it applies to (every
    position in prefill and training, one a sequence in decode; an
    encoder's ``enc_len`` frames, and the cross-attention's K/V
    projections over them, outside decode, which reads them cached); a
    MoE layer's experts at top_k / E; the head (or the tied table) on
    its logit rows (the last position of each sequence, every position
    in training). Training: 3 times the forward's."""
    rows = batch if shape_kind == "decode" else batch * seq
    enc_rows = 0 if shape_kind == "decode" else batch * enc_len
    logit_rows = batch * seq if shape_kind == "train" else batch
    total = 0.0
    for path, x in _leaves(params):
        if path[0] == "lm_head" and path[-1] == "w":
            total += 2.0 * x.numel() * logit_rows
        if path[0] not in ("layers", "enc_layers", "dec_layers") or x.dim() < 3:
            continue
        n = float(x.numel())
        if "experts" in path:
            n *= cfg.top_k / cfg.n_experts
        on_frames = path[0] == "enc_layers" or (
            "cross" in path and path[-2] in ("wk", "wv"))
        total += 2.0 * n * (enc_rows if on_frames else rows)
    if cfg.tie_embeddings:
        total += 2.0 * cfg.vocab_size * cfg.d_model * logit_rows
    return total * (3.0 if shape_kind == "train" else 1.0)


def _visible_keys(cfg, seq: int) -> float:
    """Summed over the ``seq`` query positions of a causal self-attention:
    the keys each sees (the window where there is one)."""
    if cfg.attn_kind == "sliding" and cfg.window < seq:
        w = cfg.window
        return w * (w + 1) / 2 + (seq - w) * w
    return seq * (seq + 1) / 2


def attention_flops(cfg, shape_kind: str, batch: int, seq: int,
                    enc_len: int = 1500) -> float:
    """The products of attention over its keys that ``model_flops``
    leaves out: q k^T and p v, 2 FLOPs each a query, a visible key and a
    head dim, every query head (x3 for training's backward). Decode: one
    query a sequence against its cache (the ring, for a window). An
    xLSTM has no attention; an encoder-decoder adds its encoder over
    ``enc_len`` frames and the decoder's cross attention."""
    if cfg.block_type == "xlstm_pair":
        return 0.0
    per = 4.0 * cfg.n_heads * cfg.hd * batch
    if shape_kind == "decode":
        keys = min(seq, cfg.window) if cfg.attn_kind == "sliding" else seq
        flops = per * keys * cfg.n_layers
        if cfg.is_encdec:
            flops += per * enc_len * cfg.n_layers
        return flops
    flops = per * _visible_keys(cfg, seq) * cfg.n_layers
    if cfg.is_encdec:
        flops += per * enc_len * enc_len * cfg.n_enc_layers
        flops += per * seq * enc_len * cfg.n_layers
    return flops * (3.0 if shape_kind == "train" else 1.0)


@dataclasses.dataclass
class Roofline:
    """One entry's bound on one card: ``flops`` over the peak rate of its
    compute dtype against ``bytes`` over the HBM rate."""
    arch: str
    shape: str
    flops: float  # the weight products + attention's
    model_flops: float  # the reference's count, for comparison
    bytes: float  # parameters, cache, batch and outputs, once each
    peak_ops_per_s: float = BF16_OPS_PER_S
    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    t_compute: float = 0.0
    t_memory: float = 0.0

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops / self.peak_ops_per_s
        self.t_memory = self.bytes / self.hbm_bytes_per_s
        return self

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def step_time(self) -> float:
        """The bound: the larger term (no overlap needed to reach it)."""
        return max(self.t_compute, self.t_memory)

    def row(self) -> dict:
        return {"arch": self.arch, "shape": self.shape, "chips": 1,
                "gflops": self.flops / 1e9,
                "model_gflops": self.model_flops / 1e9,
                "gbytes": self.bytes / 1e9,
                "t_compute_ms": self.t_compute * 1e3,
                "t_memory_ms": self.t_memory * 1e3,
                "bound_ms": self.step_time * 1e3,
                "bottleneck": self.bottleneck}


def roofline(cfg, shape, params, nbytes: float, *,
             enc_len: int = 1500) -> Roofline:
    """The bound of ``cfg`` at a ``specs.ShapeSpec`` (its one-card share),
    given its parameters (meta tensors) and the bytes ``launch/dryrun.py``
    counted, at the H100 SXM's rates."""
    mf = model_flops(cfg, shape.kind, shape.batch, shape.seq)
    flops = (matmul_flops(cfg, params, shape.kind, shape.batch, shape.seq, enc_len)
             + attention_flops(cfg, shape.kind, shape.batch, shape.seq, enc_len))
    return Roofline(arch=cfg.name, shape=shape.name, flops=flops,
                    model_flops=mf, bytes=float(nbytes),
                    peak_ops_per_s=peak_ops_per_s(cfg.cdtype)).finalize()
