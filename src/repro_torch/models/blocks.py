"""Per-layer blocks (port of the ``xlstm_pair`` part of
``src/repro/models/blocks.py``).

``xlstm_pair``: one mLSTM block (up-projection, chunkwise gated linear
scan, gated down-projection) followed by one sLSTM block, each pre-norm
and residual. Every block is an (init, apply, decode, cache, prefill)
set of functions over plain dict params, so that layers stack on a
leading axis (``models/backbone.py``). The reference's attention, MoE,
hybrid and encoder-decoder blocks are not ported yet (ROADMAP item 15).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.recurrent import (
    gated_linear_scan,
    gated_linear_step,
    slstm_init,
    slstm_scan,
    slstm_step,
)
from repro_torch.kernels.slstm_cell.ref import zero_state


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
    h, _ = slstm_scan(p["slstm"], rmsnorm(p["sln"], x, cfg.norm_eps), cfg.n_heads)
    return (x + dense(p["sdown"], h).to(x.dtype),
            torch.zeros((), dtype=torch.float32, device=x.device))


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
