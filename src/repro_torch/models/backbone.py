"""Backbone: blocks composed into a language model (port of
``src/repro/models/backbone.py``), for every block type: ``attn``
(dense, MoE and VLM families), ``hybrid`` (hymba), ``xlstm_pair`` and
the ``encdec`` encoder-decoder (whisper).

    forward(params, cfg, batch)                    full sequence -> logits
    prefill(params, cfg, batch, max_len)           prompt -> logits, decode cache
    decode_step(params, cfg, tokens, cache, index) one-token serve step

plus ``make_serve_step``, and training: ``loss_fn`` (cross-entropy over
the text positions, ``loss_mask``, the router aux term) and
``make_train_step`` (autograd, microbatch accumulation into one f32
gradient tree, an optimizer of ``repro_torch.optim`` stepping the
caller's parameters and state in place). With ``cfg.remat`` (the
reference's production training variant) each layer runs under a
non-reentrant activation checkpoint,
the counterpart of the reference's ``jax.checkpoint(...,
policy=nothing_saveable)``: only the layer's input is kept, and its
backward runs the layer's forward again (each forward kernel launches
twice a step). ``batch`` holds ``tokens`` and, by family,
``patches`` (the VLM's vision prefix) or ``frames`` (the audio
encoder's input). Layers are stacked on a leading axis (each leaf of
``params["layers"]`` is (n_layers, ...), as the reference's ``vmap``
init gives them) and walked by a Python loop where the reference runs
``lax.scan``; the decode cache is stacked the same way.

Training runs every block type. Its gradient goes through the
hand-written backward kernels where the forward runs a kernel: the
flash-attention backward (every attention: causal, grouped K/V heads,
the sliding window, the logit cap, cross-attention), the mLSTM-scan
backward (the mLSTM and hymba's Mamba heads) and the sLSTM's BPTT; the
rest (MoE dispatch and aux loss, the stub frontends, RoPE / M-RoPE, the
norms and MLPs) is autograd of plain tensor ops. The reference's
``_constrain`` / ``act_shard`` pin activations to a mesh and have no
counterpart on one device.

``decode_step`` writes the new token's keys and values, and the
recurrent states, into the cache it is given and returns that cache:
a caller that reuses a cache after a step clones it first
(``clone_cache``). ``init_params`` and ``init_cache`` on
``device="meta"`` draw and allocate nothing (``launch/specs.py`` sizes
entries with them).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.common.tree import (
    tree_index,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models import blocks as B
from repro_torch.models.common import (
    dense,
    dense_init,
    embed,
    embedding_init,
    normal,
    rmsnorm,
    rmsnorm_init,
    softmax_cross_entropy,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.frontends import frontend_apply, frontend_init
from repro_torch.models.rope import mrope_positions, text_positions
from repro_torch.optim import apply_updates_

MAX_LEARNED_POS = 32768  # whisper-style learned positions

_BLOCK = {
    "attn": (B.attn_block_init, B.attn_block, B.attn_block_decode,
             B.attn_block_cache, B.attn_block_prefill),
    "hybrid": (B.hybrid_block_init, B.hybrid_block, B.hybrid_block_decode,
               B.hybrid_block_cache, B.hybrid_block_prefill),
    "xlstm_pair": (B.xlstm_pair_init, B.xlstm_pair_block, B.xlstm_pair_decode,
                   B.xlstm_pair_cache, B.xlstm_pair_prefill),
}


def n_scan_layers(cfg: ArchConfig) -> int:
    if cfg.block_type == "xlstm_pair":
        if cfg.n_layers % 2:
            raise ValueError(f"xlstm_pair stacks pairs: n_layers {cfg.n_layers} is odd")
        return cfg.n_layers // 2
    return cfg.n_layers


def _stack_layers(init_fn, n, gen, cfg, dtype, device):
    stacked = None
    for i in range(n):  # one layer's draws at a time, into the stack
        stacked = _stack_into(stacked, init_fn(gen, cfg, dtype, device=device),
                              i, n)
    return stacked


def _learned_pos(gen, cfg, dtype, device):
    table = normal(gen, (MAX_LEARNED_POS, cfg.d_model), device) * 0.02
    return table.to(device=device, dtype=dtype)


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device=None):
    """Random parameters with the reference's keys, shapes and scales,
    drawn from ``gen`` (the values differ from JAX's threefry draws); on
    ``device="meta"`` shapes and dtypes only, and ``gen`` may be None."""
    device = resolve_device(device)
    dtype = cfg.pdtype
    p = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                 device=device),
         "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  device=device)
    if cfg.frontend != "none":
        p["frontend"] = frontend_init(gen, cfg, dtype, device=device)
    if cfg.pos == "learned":
        p["pos_emb"] = _learned_pos(gen, cfg, dtype, device)
    if cfg.is_encdec:
        p["enc_layers"] = _stack_layers(B.enc_block_init, cfg.n_enc_layers, gen,
                                        cfg, dtype, device)
        p["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, device=device)
        p["dec_layers"] = _stack_layers(B.dec_block_init, cfg.n_layers, gen, cfg,
                                        dtype, device)
        if cfg.pos == "learned":
            p["enc_pos_emb"] = _learned_pos(gen, cfg, dtype, device)
    else:
        p["layers"] = _stack_layers(_BLOCK[cfg.block_type][0], n_scan_layers(cfg),
                                    gen, cfg, dtype, device)
    return p


# ------------------------------------------------------------- embedding ----

def _embed_inputs(params, cfg: ArchConfig, batch):
    """Returns (x (B, S, d), positions). (The reference also returns the
    VLM's loss mask, which only its training reads.)"""
    cdt = cfg.cdtype
    tokens = batch["tokens"]
    if cfg.frontend == "vision_stub":  # VLM: [patches ; tokens]
        vis = frontend_apply(params["frontend"], cfg, batch["patches"], cdt)
        txt = embed(params["embed"], tokens, cdt)
        x = torch.cat([vis, txt], dim=1)
        return x, mrope_positions(vis.shape[0], vis.shape[1], txt.shape[1],
                                  device=x.device)
    x = embed(params["embed"], tokens, cdt)
    b, s = tokens.shape
    if cfg.pos == "learned":
        return x + params["pos_emb"][:s].to(cdt)[None], None
    return x, text_positions(b, s, device=x.device)


def _lm_logits(params, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(x.dtype).T
    return dense(params["lm_head"], x)


STACKS = ("layers", "enc_layers", "dec_layers")  # the stacked layer trees


def _layers(stacked):
    """The per-layer trees of a stacked tree, as views (``unbind``: one
    stacking node for the gradient of every layer); a list (the train
    step's per-layer gradient leaves, ``_grad_tree``) is already per
    layer."""
    if isinstance(stacked, list):
        return stacked
    leaves = [x.unbind(0) for x in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [x[i] for x in leaves])
            for i in range(len(leaves[0]))]


def _remat(cfg: ArchConfig, layer_fn):
    """``layer_fn(lp, x)`` under a non-reentrant activation checkpoint
    where ``cfg.remat`` is set and a gradient is recorded: the layer's
    saved tensors are dropped after its forward and recomputed, by
    running it again, when its backward needs them (the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)``). No layer draws
    random numbers, so no RNG state is stashed."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer_fn

    def run(lp, x):
        return torch.utils.checkpoint.checkpoint(layer_fn, lp, x, use_reentrant=False,
                                                 preserve_rng_state=False)

    return run


# --------------------------------------------------------------- forward ----

def forward(params, cfg: ArchConfig, batch):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    if cfg.is_encdec:
        return _encdec_forward(params, cfg, batch)
    x, positions = _embed_inputs(params, cfg, batch)
    apply_fn = _BLOCK[cfg.block_type][1]
    layer = _remat(cfg, lambda lp, h: apply_fn(lp, cfg, h, positions))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params["layers"]):
        x, a = layer(lp, x)
        aux = aux + a
    return _lm_logits(params, cfg, x), aux


def _encode(params, cfg: ArchConfig, frames):
    cdt = cfg.cdtype
    x = frontend_apply(params["frontend"], cfg, frames, cdt)
    x = x + params["enc_pos_emb"][:x.shape[1]].to(cdt)[None]
    layer = _remat(cfg, lambda lp, h: B.enc_block(lp, cfg, h, None))
    for lp in _layers(params["enc_layers"]):
        x, _ = layer(lp, x)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _embed_decoder(params, cfg: ArchConfig, tokens):
    x = embed(params["embed"], tokens, cfg.cdtype)
    return x + params["pos_emb"][:tokens.shape[1]].to(cfg.cdtype)[None]


def _encdec_forward(params, cfg: ArchConfig, batch):
    enc_out = _encode(params, cfg, batch["frames"])
    x = _embed_decoder(params, cfg, batch["tokens"])
    layer = _remat(cfg, lambda lp, h: B.dec_block(lp, cfg, h, enc_out, None))
    for lp in _layers(params["dec_layers"]):
        x, _ = layer(lp, x)
    return _lm_logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                   device=x.device)


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy (over ``loss_mask`` where given; the
    text positions of a VLM) plus ``router_aux_weight`` times the aux
    loss. Returns (total, {"loss", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        # loss only over the text region (vision tokens have no labels)
        logits = logits[:, batch["patches"].shape[1]:]
    ce = softmax_cross_entropy(logits, labels)
    mask = batch.get("loss_mask")
    if mask is None:
        loss = torch.mean(ce)
    else:
        loss = torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def _value_and_grad(params, cfg: ArchConfig, batch):
    """(total, metrics, grads) of ``loss_fn`` at ``params``, all detached."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(total, leaves)
    return (total.detach(), tree_map(torch.Tensor.detach, metrics),
            tree_unflatten(params, list(grads)))


def _grad_leaf(p, g):
    """``p`` detached, as a leaf that records its gradient into ``g``:
    autograd's accumulation adds each gradient it reaches into a leaf's
    ``.grad`` in place."""
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _grad_tree(params, grads):
    """``params`` for ``loss_fn``, each leaf one of ``_grad_leaf`` over
    the matching leaf of ``grads``; a stacked layer tree is given as the
    list of its layers' trees (views of each stacked leaf, ``_layers``),
    so that each layer's gradient lands in its slice of the stacked
    gradient as the backward reaches it (``unbind``'s backward would
    hold every layer's gradient until the last, and then stack them
    into a copy). Returns (the tree, its leaves)."""
    tree, leaves = {}, []
    for key, sub in params.items():
        if key in STACKS:
            gl = tree_leaves(grads[key])
            tree[key] = [tree_unflatten(sub, [_grad_leaf(p[i], g[i]) for p, g in
                                               zip(tree_leaves(sub), gl)])
                         for i in range(gl[0].shape[0])]
            leaves += [x for lp in tree[key] for x in tree_leaves(lp)]
        else:
            tree[key] = tree_map(_grad_leaf, sub, grads[key])
            leaves += tree_leaves(tree[key])
    return tree, leaves


def make_train_step(cfg: ArchConfig, optimizer, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``microbatches`` > 1 the batch's leading axis is cut
    into that many microbatches, run one after another; the gradients
    are summed in f32 and divided by ``microbatches``, and the metrics
    are loss = the mean total and aux = 0, as the reference reports
    them.

    The step owns what it is given (f32 parameters; an optimizer with an
    in-place ``update_``): it returns the same parameter and state
    tensors, stepped in place, so a caller that keeps its parameters
    passes a clone. The gradients go into one f32 tree as autograd
    computes them, and the update overwrites them leaf by leaf, so a
    step holds no tree beyond the parameters, the moments and that one;
    the results are those of the out-of-place composition
    (``_value_and_grad``, f32 sums, ``optimizer.update``,
    ``apply_updates``) bit for bit."""

    def train_step(params, opt_state, batch):
        if optimizer.update_ is None:
            raise ValueError("the train step updates in place: the optimizer "
                             "has no update_")
        if any(x.dtype != torch.float32 for x in tree_leaves(params)):
            raise ValueError("the train step accumulates into f32 parameters' "
                             "gradients")
        # the f32 gradient tree, also the microbatches' accumulator: each
        # gradient is added into it as autograd reaches its leaf (per-leaf
        # temporaries only), as the reference adds each microbatch's
        # gradient to its zeros
        grads = tree_map(torch.zeros_like, params)
        tree, leaves = _grad_tree(params, grads)
        parts = ([batch] if microbatches == 1 else [
            {k: v.reshape((microbatches, v.shape[0] // microbatches)
                          + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            for i in range(microbatches)])
        total = None
        for mb in parts:
            with torch.enable_grad():
                t, metrics = loss_fn(tree, cfg, mb)
                torch.autograd.backward(t, inputs=leaves)
            t = t.detach()
            total = t if total is None else total + t
        del tree, leaves
        if microbatches > 1:
            for g in tree_leaves(grads):
                g.div_(microbatches)
            total = total / microbatches
            metrics = {"loss": total, "aux": torch.zeros_like(total)}
        else:
            metrics = tree_map(torch.Tensor.detach, metrics)
        updates, opt_state = optimizer.update_(grads, opt_state, params)
        apply_updates_(params, updates)
        return params, opt_state, dict(metrics, total=total)

    return train_step


# --------------------------------------------------------------- serving ----

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               enc_len: int = 1500, device=None):
    """Decode cache for the whole stack (leading axis = stacked layers),
    all zeros, as the reference's. enc_len: the encoder output length of
    the cross-attention cache (encdec)."""
    device = resolve_device(device)
    dtype = dtype or cfg.cdtype
    if cfg.is_encdec:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
        single = {"self": B.attn_block_cache(cfg, batch, max_len, dtype,
                                             device=device),
                  "cross": (torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))}
    else:
        single = _BLOCK[cfg.block_type][3](cfg, batch, max_len, dtype,
                                           device=device)
    n = n_scan_layers(cfg)
    return tree_map(lambda x: torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                                          device=x.device), single)


def prefill(params, cfg: ArchConfig, batch, max_len: int, cache_dtype=None):
    """Process the prompt; returns (last-token logits (B, 1, V), cache,
    next_index)."""
    cache_dtype = cache_dtype or cfg.cdtype
    if cfg.is_encdec:
        return _encdec_prefill(params, cfg, batch, max_len, cache_dtype)
    x, positions = _embed_inputs(params, cfg, batch)
    prefill_fn = _BLOCK[cfg.block_type][4]
    layers = _layers(params["layers"])
    cache = None
    for i, lp in enumerate(layers):
        x, cache_l = prefill_fn(lp, cfg, x, positions, max_len, cache_dtype)
        cache = _stack_into(cache, cache_l, i, len(layers))
    logits = _lm_logits(params, cfg, x[:, -1:])
    return logits, cache, x.shape[1]


def _stack_into(stacked, cache_l, i: int, n: int):
    """Layer ``i``'s cache into slot i of the stacked cache of ``n``
    layers (made at layer 0): the stack is built in place, so that
    prefill never holds every layer's cache twice."""
    if stacked is None:
        stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), cache_l)
    tree_map(lambda dst, src: dst[i].copy_(src), stacked, cache_l)
    return stacked


def _encdec_prefill(params, cfg, batch, max_len, cache_dtype):
    enc_out = _encode(params, cfg, batch["frames"])
    tok = batch["tokens"]  # decoder prompt (e.g. BOS)
    x = _embed_decoder(params, cfg, tok)
    layers = _layers(params["dec_layers"])
    cache = None
    for i, lp in enumerate(layers):
        x, cache_l = B.dec_block_prefill(lp, cfg, x, enc_out, None, max_len,
                                         cache_dtype)
        cache = _stack_into(cache, cache_l, i, len(layers))
    logits = _lm_logits(params, cfg, x[:, -1:])
    return logits, cache, tok.shape[1]


def decode_step(params, cfg: ArchConfig, tokens, cache, index):
    """tokens (B, 1) int; index: count of tokens already in context.
    Returns (logits (B, 1, V), cache): the cache passed in, updated in
    place (the token's K/V at slot ``index % length`` of each ring, each
    recurrent state replaced by the next)."""
    index = int(index)
    x = embed(params["embed"], tokens, cfg.cdtype)
    if cfg.pos == "learned":
        x = x + params["pos_emb"][min(index, MAX_LEARNED_POS - 1)].to(cfg.cdtype)
    positions = None
    if cfg.pos == "mrope":  # the raw index on all three axes, as the reference
        positions = torch.full((tokens.shape[0], 1, 3), index, dtype=torch.int32,
                               device=x.device)
    if cfg.is_encdec:
        for i, lp in enumerate(_layers(params["dec_layers"])):
            view = tree_index(cache, i)
            x, cache_l = B.dec_block_decode(lp, cfg, x, view, index)
            _write_back(view, cache_l)
    else:
        decode_fn = _BLOCK[cfg.block_type][2]
        for i, lp in enumerate(_layers(params["layers"])):
            view = tree_index(cache, i)
            x, cache_l = decode_fn(lp, cfg, x, view, index, positions)
            _write_back(view, cache_l)
    return _lm_logits(params, cfg, x), cache


def _write_back(view, cache_l) -> None:
    """A layer's next cache into its views of the stacked cache: leaves
    the block updated in place (the K/V rings) are those views already;
    the others (recurrent states) are copied in."""
    def put(dst, src):
        if src is not dst:
            dst.copy_(src)

    tree_map(put, view, cache_l)


def clone_cache(cache):
    """A copy of a decode cache, for a caller that reuses a cache after
    ``decode_step`` (which updates the one it is given)."""
    return tree_map(torch.clone, cache)


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, tokens, cache, index):
        return decode_step(params, cfg, tokens, cache, index)

    return serve_step
