"""Per-layer blocks for every family (port of
``src/repro/models/blocks.py``).

Block types
-----------
attn        pre-norm attention + (MLP | MoE)          [dense, moe, vlm]
hybrid      parallel attention + Mamba-2 SSD heads    [hymba]
xlstm_pair  one mLSTM block + one sLSTM block         [xlstm]
encdec      encoder block / decoder block w/ cross    [whisper]

Every block is an (init, apply, decode, cache, prefill) set of functions
over plain dict params, so that layers stack on a leading axis
(``models/backbone.py``). Attention goes through the flash kernel
(``models/attention.py``), the Mamba heads' scan and the mLSTM's through
the mLSTM scan kernel (``gated_linear_scan``), the sLSTM through the
sLSTM cell kernel; the one-token decode steps of the Mamba heads and
the mLSTM are plain tensor ops, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_cell.ref import zero_state
from repro_torch.models.attention import (
    attend,
    attn_init,
    decode_attend,
    decode_cross_attend,
    init_kv_cache,
)
from repro_torch.models.common import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.mlp import mlp, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.recurrent import (
    gated_linear_scan,
    gated_linear_step,
    slstm_init,
    slstm_scan,
    slstm_step,
)


def _no_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ attn ----

def attn_block_init(gen, cfg, dtype, *, device):
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device=device),
        "attn": attn_init(gen, cfg, dtype, device=device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg, dtype, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device)
    return p


def _ffn(p, cfg, h):
    """The block's MLP or MoE: (out, aux loss)."""
    if "moe" in p:
        return moe_apply(p["moe"], cfg, h)
    return mlp(p["mlp"], h, cfg.act), _no_aux(h)


def attn_block(p, cfg, x, positions, causal=True):
    a, _ = attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                  causal=causal)
    x = x + a
    m, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + m, aux


def attn_block_decode(p, cfg, x, cache, index, positions=None):
    a, cache = decode_attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cache, index, positions)
    x = x + a
    m, _ = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + m, cache


def attn_block_cache(cfg, batch, max_len, dtype, *, device):
    return init_kv_cache(cfg, batch, max_len, dtype, device=device)


# ---------------------------------------------------------------- hybrid ----

def _mamba_init(gen, cfg, dtype, *, device):
    d, h, pdim, n = cfg.d_model, cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "wxz": dense_init(gen, d, 2 * h * pdim, dtype, device=device),
        "wbc": dense_init(gen, d, 2 * h * n, dtype, device=device),
        "wdt": dense_init(gen, d, h, dtype, device=device, bias=True),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "dskip": torch.ones((h,), dtype=torch.float32, device=device),
        "down": dense_init(gen, h * pdim, d, dtype, device=device),
    }


def _mamba_qkvf(p, cfg, xn):
    """Shared projection math for scan and step. xn (B, S, d) -> q = C,
    k = B, v = x (each (B, H, S, *)), log_f (B, H, S) <= 0, x (B, S, H,
    P) and the gate z."""
    b, s, d = xn.shape
    h, pdim, n = cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    xz = dense(p["wxz"], xn).reshape(b, s, 2, h, pdim)
    xin, z = xz[:, :, 0], xz[:, :, 1]
    bc = dense(p["wbc"], xn).reshape(b, s, 2, h, n)
    bt, ct = bc[:, :, 0], bc[:, :, 1]
    dt = F.softplus(dense(p["wdt"], xn).float())  # (B, S, H)
    log_f = -torch.exp(p["a_log"])[None, None, :] * dt

    def tr(t):  # (B, S, H, *) -> (B, H, S, *)
        return t.transpose(1, 2)

    return tr(ct), tr(bt), tr(xin), log_f.transpose(1, 2), xin, z


def mamba_apply(p, cfg, xn, chunk=64, return_state=False):
    q, k, v, log_f, xin, z = _mamba_qkvf(p, cfg, xn)
    res = gated_linear_scan(q, k, v, log_f, chunk=chunk, normalize=False,
                            return_state=return_state)
    hseq, state = res if return_state else (res, None)
    hseq = hseq.transpose(1, 2)  # (B, S, H, P) f32 from the scan
    hseq = hseq + p["dskip"].to(hseq.dtype)[None, None, :, None] * xin
    out = hseq * F.silu(z)
    b, s = xn.shape[:2]
    y = dense(p["down"], out.reshape(b, s, -1)).to(xn.dtype)
    return (y, state) if return_state else y


def mamba_step(p, cfg, xn, state):
    """xn (B, 1, d); state (C, n)."""
    q, k, v, log_f, xin, z = _mamba_qkvf(p, cfg, xn)
    hv, state = gated_linear_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                  log_f[:, :, 0], state, normalize=False)
    hv = hv + p["dskip"].to(hv.dtype)[None, :, None] * xin[:, 0]
    out = hv[:, None] * F.silu(z)
    b = xn.shape[0]
    return dense(p["down"], out.reshape(b, 1, -1)), state


def hybrid_block_init(gen, cfg, dtype, *, device):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device=device),
        "attn": attn_init(gen, cfg, dtype, device=device),
        "mamba": _mamba_init(gen, cfg, dtype, device=device),
        # learnable fusion (Hymba)
        "beta": torch.tensor([0.5, 0.5], dtype=torch.float32, device=device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device=device),
    }


def _fuse(p, cfg, x, a, m):
    beta = p["beta"].to(x.dtype)
    x = x + beta[0] * a + beta[1] * m
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)


def hybrid_block(p, cfg, x, positions):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, _ = attend(p["attn"], cfg, xn, positions, causal=True)
    m = mamba_apply(p["mamba"], cfg, xn)
    return _fuse(p, cfg, x, a, m), _no_aux(x)


def hybrid_block_decode(p, cfg, x, cache, index, positions=None):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = decode_attend(p["attn"], cfg, xn, cache["attn"], index, positions)
    m, ssm = mamba_step(p["mamba"], cfg, xn, cache["ssm"])
    return _fuse(p, cfg, x, a, m), {"attn": kv, "ssm": ssm}


def hybrid_block_cache(cfg, batch, max_len, dtype, *, device):
    h, pdim, n = cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "attn": init_kv_cache(cfg, batch, max_len, dtype, device=device),
        "ssm": (torch.zeros((batch, h, n, pdim), dtype=torch.float32, device=device),
                torch.zeros((batch, h, n), dtype=torch.float32, device=device)),
    }


# ------------------------------------------------------------ xlstm_pair ----

def _mlstm_init(gen, cfg, dtype, *, device):
    d = cfg.d_model
    ed = cfg.ssm_expand * d
    return {
        "ln": rmsnorm_init(d, dtype, device=device),
        "up": dense_init(gen, d, 2 * ed, dtype, device=device),
        "wq": dense_init(gen, ed, ed, dtype, device=device),
        "wk": dense_init(gen, ed, ed, dtype, device=device),
        "wv": dense_init(gen, ed, ed, dtype, device=device),
        "wg": dense_init(gen, d, 2 * cfg.n_heads, dtype, device=device, bias=True),
        "down": dense_init(gen, ed, d, dtype, device=device),
    }


def _mlstm_qkvf(p, cfg, xn):
    b, s, d = xn.shape
    h = cfg.n_heads
    ed = cfg.ssm_expand * d
    hd = ed // h
    u = dense(p["up"], xn).reshape(b, s, 2, ed)
    xin, z = u[:, :, 0], u[:, :, 1]

    def to_heads(t):
        return t.reshape(b, s, h, hd).permute(0, 2, 1, 3)

    # divided by sqrt(hd) in f32 as the reference does (sqrt(512) is not a
    # power of 2, so a multiply by its reciprocal would round otherwise);
    # a 0-dim device tensor keeps the CUDA division an IEEE division
    sqrt_hd = torch.sqrt(torch.tensor(float(hd), device=xn.device)).to(xn.dtype)
    q = to_heads(dense(p["wq"], xin)) / sqrt_hd
    k = to_heads(dense(p["wk"], xin))
    v = to_heads(dense(p["wv"], xin))
    g = dense(p["wg"], xn).float().reshape(b, s, 2, h)
    log_f = F.logsigmoid(g[:, :, 0])  # (B, S, H)
    i_gate = torch.sigmoid(g[:, :, 1])
    k = k * i_gate.permute(0, 2, 1)[..., None].to(k.dtype)
    return q, k, v, log_f.permute(0, 2, 1), z


def mlstm_apply(p, cfg, x, chunk=64, return_state=False):
    xn = rmsnorm(p["ln"], x, cfg.norm_eps)
    q, k, v, log_f, z = _mlstm_qkvf(p, cfg, xn)
    res = gated_linear_scan(q, k, v, log_f, chunk=chunk, normalize=True,
                            return_state=return_state)
    hseq, state = res if return_state else (res, None)
    b, h, s, hd = hseq.shape
    hseq = hseq.permute(0, 2, 1, 3).reshape(b, s, h * hd)  # f32 from the scan
    y = x + dense(p["down"], hseq * F.silu(z)).to(x.dtype)
    return (y, state) if return_state else y


def mlstm_step(p, cfg, x, state):
    xn = rmsnorm(p["ln"], x, cfg.norm_eps)
    q, k, v, log_f, z = _mlstm_qkvf(p, cfg, xn)
    hv, state = gated_linear_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                  log_f[:, :, 0], state, normalize=True)
    b = x.shape[0]
    out = hv.reshape(b, 1, -1) * F.silu(z)
    return x + dense(p["down"], out), state


def xlstm_pair_init(gen, cfg, dtype, *, device):
    return {
        "mlstm": _mlstm_init(gen, cfg, dtype, device=device),
        "sln": rmsnorm_init(cfg.d_model, dtype, device=device),
        "slstm": slstm_init(gen, cfg.d_model, cfg.n_heads, dtype, device=device),
        "sdown": dense_init(gen, cfg.d_model, cfg.d_model, dtype, device=device),
    }


def xlstm_pair_block(p, cfg, x, positions):
    del positions
    x = mlstm_apply(p["mlstm"], cfg, x)
    # no final state: the sLSTM's gradient path returns none
    h, _ = slstm_scan(p["slstm"], rmsnorm(p["sln"], x, cfg.norm_eps), cfg.n_heads,
                      return_state=False)
    return x + dense(p["sdown"], h).to(x.dtype), _no_aux(x)


def xlstm_pair_decode(p, cfg, x, cache, index, positions=None):
    del index, positions
    x, mstate = mlstm_step(p["mlstm"], cfg, x, cache["m"])
    h, sstate = slstm_step(p["slstm"], rmsnorm(p["sln"], x, cfg.norm_eps)[:, 0],
                           cfg.n_heads, cache["s"])
    x = x + dense(p["sdown"], h[:, None]).to(x.dtype)
    return x, {"m": mstate, "s": sstate}


def xlstm_pair_cache(cfg, batch, max_len, dtype, *, device):
    """One layer's decode state: the mLSTM (C, n) and the sLSTM (c, n, m,
    h) at the start of a sequence, all f32."""
    del max_len, dtype
    d, h = cfg.d_model, cfg.n_heads
    hd_m = cfg.ssm_expand * d // h
    return {
        "m": (torch.zeros((batch, h, hd_m, hd_m), dtype=torch.float32, device=device),
              torch.zeros((batch, h, hd_m), dtype=torch.float32, device=device)),
        "s": zero_state(batch, h, d // h, device),
    }


def xlstm_pair_prefill(p, cfg, x, positions, max_len, cache_dtype):
    del positions, max_len, cache_dtype
    x, mstate = mlstm_apply(p["mlstm"], cfg, x, return_state=True)
    h, sstate = slstm_scan(p["slstm"], rmsnorm(p["sln"], x, cfg.norm_eps),
                           cfg.n_heads)
    return x + dense(p["sdown"], h).to(x.dtype), {"m": mstate, "s": sstate}


# ---------------------------------------------------------------- encdec ----

def enc_block_init(gen, cfg, dtype, *, device):
    return attn_block_init(gen, cfg, dtype, device=device)


def enc_block(p, cfg, x, positions):
    return attn_block(p, cfg, x, positions, causal=False)


def dec_block_init(gen, cfg, dtype, *, device):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device=device),
        "attn": attn_init(gen, cfg, dtype, device=device),
        "lnx": rmsnorm_init(cfg.d_model, dtype, device=device),
        "cross": attn_init(gen, cfg, dtype, device=device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, device=device),
    }


def _dec_rest(p, cfg, x, a, enc_out):
    """The decoder block after its self-attention: (out, cross K/V)."""
    x = x + a
    c, cross_kv = attend(p["cross"], cfg, rmsnorm(p["lnx"], x, cfg.norm_eps), None,
                         causal=False, kv_x=enc_out)
    x = x + c
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act), cross_kv


def dec_block(p, cfg, x, enc_out, positions):
    a, _ = attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                  causal=True)
    return _dec_rest(p, cfg, x, a, enc_out)


def dec_block_decode(p, cfg, x, cache, index):
    a, kv = decode_attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                          cache["self"], index)
    x = x + a
    c = decode_cross_attend(p["cross"], cfg, rmsnorm(p["lnx"], x, cfg.norm_eps),
                            cache["cross"])
    x = x + c
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.act), {"self": kv, "cross": cache["cross"]}


# --------------------------------------------------------------- prefill ----
# Prefill variants run the full-sequence math AND return a decode-ready
# cache (ring-buffer KV for attention, final recurrent states for SSM).

def _kv_to_ring(cfg, k_raw, v_raw, max_len, dtype):
    """Pack full-sequence (B, S, Hkv, hd) K/V into a ring buffer cache:
    the absolute position p sits at slot p % length, and past a wrap the
    last ``length`` positions are kept. (The reference's permutation
    puts them there only when (S - length) % length is 0 or length / 2;
    ROADMAP fault (l).)"""
    s = k_raw.shape[1]
    length = min(max_len, cfg.window) if cfg.attn_kind == "sliding" else max_len
    if s >= length:
        start = (s - length) % length  # the slot of the oldest kept position
        k_buf = torch.roll(k_raw[:, s - length:], start, dims=1)
        v_buf = torch.roll(v_raw[:, s - length:], start, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, length - s)
        k_buf, v_buf = F.pad(k_raw, pad), F.pad(v_raw, pad)
    return {"k": k_buf.to(dtype), "v": v_buf.to(dtype)}


def attn_block_prefill(p, cfg, x, positions, max_len, cache_dtype):
    a, (k_raw, v_raw) = attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                               positions, causal=True)
    x = x + a
    m, _ = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + m, _kv_to_ring(cfg, k_raw, v_raw, max_len, cache_dtype)


def hybrid_block_prefill(p, cfg, x, positions, max_len, cache_dtype):
    xn = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, (k_raw, v_raw) = attend(p["attn"], cfg, xn, positions, causal=True)
    m, ssm = mamba_apply(p["mamba"], cfg, xn, return_state=True)
    cache = {"attn": _kv_to_ring(cfg, k_raw, v_raw, max_len, cache_dtype),
             "ssm": ssm}
    return _fuse(p, cfg, x, a, m), cache


def dec_block_prefill(p, cfg, x, enc_out, positions, max_len, cache_dtype):
    a, (k_raw, v_raw) = attend(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                               positions, causal=True)
    x, cross_kv = _dec_rest(p, cfg, x, a, enc_out)
    cache = {
        "self": _kv_to_ring(cfg, k_raw, v_raw, max_len, cache_dtype),
        "cross": (cross_kv[0].to(cache_dtype), cross_kv[1].to(cache_dtype)),
    }
    return x, cache
