"""Per-modality encoders and classifiers (port of the ``mlp`` path of
``src/repro/core/encoders.py``).

    f_m : (B, S_m, F_m) -> h (B, d)        modality encoder
    g_m : h -> logits                       unimodal classifier
    g_M : (h_A, h_B) -> logits              multimodal (fusion) classifier

Parameters are plain dicts keyed like the reference's pytrees (the
``mlp`` encoder's ``hidden`` is a list), so JAX weights and checkpoints
carry over through ``repro_torch.convert``. ``jax.nn.gelu`` is the tanh
form, hence ``approximate="tanh"`` throughout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.data.synthetic import TaskSpec
from repro_torch.models.common import (
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    sigmoid_bce,
    softmax_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    d_hidden: int = 64
    n_layers: int = 2
    enc_type: str = "mlp"  # mlp | recurrent | transformer
    n_heads: int = 4


def _check_enc_type(ecfg: EncoderConfig) -> None:
    if ecfg.enc_type in ("recurrent", "transformer"):
        raise NotImplementedError(
            f"enc_type={ecfg.enc_type!r} is not ported yet (ROADMAP.md, "
            "modules to port: 'Encoder variants'); the port runs 'mlp'")
    if ecfg.enc_type != "mlp":
        raise ValueError(ecfg.enc_type)


def encoder_init(gen: torch.Generator, feat_dim: int, ecfg: EncoderConfig,
                 dtype=torch.float32, *, device):
    _check_enc_type(ecfg)
    d = ecfg.d_hidden
    return {
        "in": dense_init(gen, feat_dim, d, dtype, device=device, bias=True),
        "hidden": [dense_init(gen, d, d, dtype, device=device, bias=True)
                   for _ in range(ecfg.n_layers)],
        "norm": rmsnorm_init(d, dtype, device=device),
    }


def encoder_apply(p, x, ecfg: EncoderConfig):
    """x (B, S, F) -> h (B, d)."""
    _check_enc_type(ecfg)
    h = torch.tanh(dense(p["in"], x))
    h = torch.mean(h, dim=1)
    for layer in p["hidden"]:
        h = h + F.gelu(dense(layer, h), approximate="tanh")
    return rmsnorm(p["norm"], h)


def head_init(gen: torch.Generator, d_in: int, n_out: int,
              dtype=torch.float32, *, device):
    return dense_init(gen, d_in, n_out, dtype, device=device, bias=True)


def fusion_init(gen: torch.Generator, d: int, n_out: int,
                dtype=torch.float32, *, device):
    return {"mix": dense_init(gen, 2 * d, d, dtype, device=device, bias=True),
            "out": dense_init(gen, d, n_out, dtype, device=device, bias=True)}


def fusion_apply(p, h_a, h_b):
    h = F.gelu(dense(p["mix"], torch.cat([h_a, h_b], dim=-1)),
               approximate="tanh")
    return dense(p["out"], h)


# ------------------------------------------------------- model container ----

def init_client_models(gen: torch.Generator, spec: TaskSpec,
                       ecfg: EncoderConfig, dtype=torch.float32, *,
                       device=None):
    """Full per-client model set {f_A, f_B, g_A, g_B, g_M} on ``device``
    (CUDA when None)."""
    device = resolve_device(device)
    d = ecfg.d_hidden
    return {
        "f_A": encoder_init(gen, spec.feat_a, ecfg, dtype, device=device),
        "f_B": encoder_init(gen, spec.feat_b, ecfg, dtype, device=device),
        "g_A": head_init(gen, d, spec.out_dim, dtype, device=device),
        "g_B": head_init(gen, d, spec.out_dim, dtype, device=device),
        "g_M": fusion_init(gen, d, spec.out_dim, dtype, device=device),
    }


def predict_unimodal(models, x, modality: str, ecfg: EncoderConfig):
    h = encoder_apply(models[f"f_{modality}"], x, ecfg)
    return dense(models[f"g_{modality}"], h)


def predict_multimodal(models, x_a, x_b, ecfg: EncoderConfig):
    h_a = encoder_apply(models["f_A"], x_a, ecfg)
    h_b = encoder_apply(models["f_B"], x_b, ecfg)
    return fusion_apply(models["g_M"], h_a, h_b)


def task_loss(logits, y, kind: str):
    if kind == "multiclass":
        labels = torch.argmax(y, dim=-1)
        return torch.mean(softmax_cross_entropy(logits, labels))
    return torch.mean(sigmoid_bce(logits, y))  # binary / multilabel


def task_scores(logits, kind: str):
    """Probability scores for AUROC/AUPRC computation."""
    if kind == "multiclass":
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)
