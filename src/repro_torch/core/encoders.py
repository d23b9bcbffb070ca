"""Per-modality encoders and classifiers (port of
``src/repro/core/encoders.py``).

    f_m : (B, S_m, F_m) -> h (B, d)        modality encoder
    g_m : h -> logits                       unimodal classifier
    g_M : (h_A, h_B) -> logits              multimodal (fusion) classifier

``enc_type``: ``mlp``; ``recurrent``, one sLSTM layer over the sequence
through the sLSTM cell kernel; ``transformer``, one non-causal attention
block through the flash attention kernel. All three are differentiable:
the two kernels' gradients run their backward kernels on the card.
Parameters are plain dicts keyed like the reference's pytrees (the
``mlp`` encoder's ``hidden`` is a list), so JAX weights and checkpoints
carry over through ``repro_torch.convert``. ``jax.nn.gelu`` is the tanh form, hence
``approximate="tanh"`` throughout.

The reference's transformer scores divide by ``sqrt(hd)``; the kernel
multiplies by ``1 / sqrt(hd)`` in f32. The two are equal when ``hd`` is
a power of 4 (64 and 256 among the configurations) and differ by an ulp
of the score otherwise.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.data.synthetic import TaskSpec
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    sigmoid_bce,
    softmax_cross_entropy,
)
from repro_torch.models.recurrent import slstm_init, slstm_scan

ENC_TYPES = ("mlp", "recurrent", "transformer")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    d_hidden: int = 64
    n_layers: int = 2
    enc_type: str = "mlp"  # mlp | recurrent | transformer
    n_heads: int = 4


def _check_enc_type(ecfg: EncoderConfig) -> None:
    if ecfg.enc_type not in ENC_TYPES:
        raise ValueError(ecfg.enc_type)


def encoder_init(gen: torch.Generator, feat_dim: int, ecfg: EncoderConfig,
                 dtype=torch.float32, *, device):
    _check_enc_type(ecfg)
    d = ecfg.d_hidden
    p = {"in": dense_init(gen, feat_dim, d, dtype, device=device, bias=True)}
    if ecfg.enc_type == "mlp":
        p["hidden"] = [dense_init(gen, d, d, dtype, device=device, bias=True)
                       for _ in range(ecfg.n_layers)]
    elif ecfg.enc_type == "recurrent":
        p["cell"] = slstm_init(gen, d, ecfg.n_heads, dtype, device=device)
    else:  # transformer; independent draws (see ROADMAP.md §3 on the
        # reference's key reuse)
        p["ln"] = rmsnorm_init(d, dtype, device=device)
        for name in ("wq", "wk", "wv"):
            p[name] = dense_init(gen, d, d, dtype, device=device)
        p["ff"] = dense_init(gen, d, d, dtype, device=device, bias=True)
    p["norm"] = rmsnorm_init(d, dtype, device=device)
    return p


def encoder_apply(p, x, ecfg: EncoderConfig):
    """x (B, S, F) -> h (B, d)."""
    _check_enc_type(ecfg)
    h = torch.tanh(dense(p["in"], x))
    if ecfg.enc_type == "mlp":
        h = torch.mean(h, dim=1)
        for layer in p["hidden"]:
            h = h + F.gelu(dense(layer, h), approximate="tanh")
    elif ecfg.enc_type == "recurrent":
        h = slstm_scan(p["cell"], h, ecfg.n_heads, return_state=False)[0][:, -1]
    else:  # transformer
        hn = rmsnorm(p["ln"], h)
        b, s, d = hn.shape
        nh = ecfg.n_heads

        def heads(w):  # (b, s, d) -> (b, nh, s, hd)
            return dense(w, hn).reshape(b, s, nh, d // nh).permute(0, 2, 1, 3)

        att = flash_attention(heads(p["wq"]), heads(p["wk"]), heads(p["wv"]),
                              causal=False)
        h = h + att.permute(0, 2, 1, 3).reshape(b, s, d)
        h = h + F.gelu(dense(p["ff"], h), approximate="tanh")
        h = torch.mean(h, dim=1)
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
