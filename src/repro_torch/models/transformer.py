"""Dense decoder-only transformer (llama/qwen family) as an ``nn.Module``.

Covers the dense configs of the reference: qwen3-4b (qk_norm), qwen2-72b
and qwen2.5-32b (QKV bias), smollm-360m, and the backbones of
musicgen-large and internvl2-76b, whose frontends are stubs (precomputed
frame or patch embeddings, ``batch["embeds"]``, are prepended to the token
embeddings).  One :class:`Block` module per layer holds that layer's
parameters under the reference's names (``ln1``, ``wq``, ...), with
projections as ``nn.Linear`` (``models/params.py`` converts the layouts).

Build a model with :func:`build` from a parameter tree in the reference's
layout: :func:`~repro_torch.models.params.init_params` over
:func:`param_defs` for random weights, or the reference's own tree as numpy
arrays.  :func:`forward` has the reference's signature; with
``return_hidden=True`` it returns the hidden states before the final norm.
Training calls the module itself under autograd (``train/train_state.py``);
with ``cfg.remat == "block"`` each block is recomputed in the backward pass.

Decoding keeps the reference's convention: ``forward(..., return_cache=True)``
over S tokens returns the logits and ``{"k", "v", "pos"}`` with the
layer-stacked roped keys and values ``(L, B, S, Hkv, hd)`` and ``pos = S - 1``;
:func:`decode_step` puts the next token at ``pos + 1``, attends the old cache
below it plus the token itself (``layers.attn_decode``, grouped: the cache
is never expanded to the query heads), and writes the new keys and values
into the cache once, after the layers (``layers.update_cache``, in place).
The cache must have room: :func:`~repro_torch.models.common.grow_cache`, or
zeros of :func:`cache_defs`' shapes.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.layers import (NOCTX, Ctx, apply_rope, attn_chunked,
                                       attn_decode, attn_full, gated_mlp,
                                       replicated_like, rms_norm,
                                       rope_tables, update_cache)
from repro_torch.models.params import ParamDef

#: longest sequence attended with materialised scores (the reference's
#: ``use_full`` switch); longer ones take the chunked online softmax
FULL_ATTN_MAX = 2048


def _kv_axis(cfg, tp: int):
    """KV heads shard over the tensor axis when ``tp`` divides them (the
    reference's rule; a dry-run sizes a production mesh with it)."""
    return "tensor" if (tp > 1 and cfg.n_kv_heads % tp == 0) else None


def block_defs(cfg, tp: int = 1) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    He = cfg.heads_padded(tp)
    Hkv = cfg.n_kv_heads
    kv_ax = _kv_axis(cfg, tp)
    defs = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "wq": ParamDef((d, He, hd), ("embed", "tensor", None), fan_in=d),
        "wk": ParamDef((d, Hkv, hd), ("embed", kv_ax, None), fan_in=d),
        "wv": ParamDef((d, Hkv, hd), ("embed", kv_ax, None), fan_in=d),
        "wo": ParamDef((He, hd, d), ("tensor", None, "embed"), fan_in=He * hd),
        "wg": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wu": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wd": ParamDef((cfg.d_ff, d), ("tensor", "embed"), fan_in=cfg.d_ff),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": ParamDef((He, hd), ("tensor", None), init="zeros"),
            "bk": ParamDef((Hkv, hd), (kv_ax, None), init="zeros"),
            "bv": ParamDef((Hkv, hd), (kv_ax, None), init="zeros"),
        })
    if cfg.qk_norm:
        defs.update({
            "qnorm": ParamDef((hd,), (None,), init="ones"),
            "knorm": ParamDef((hd,), (None,), init="ones"),
        })
    return defs


def param_defs(cfg, tp: int = 1) -> dict:
    return {
        **common.embed_defs(cfg),
        "layers": common.stack_layer_defs(block_defs(cfg, tp), cfg.n_layers),
    }


class Block(nn.Module):
    """One decoder layer: pre-norm attention and pre-norm SwiGLU MLP, with
    the query heads padded to a multiple of ``tp`` (the padding heads are
    masked)."""

    def __init__(self, cfg, tp: int = 1):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        H, Hkv = cfg.heads_padded(tp), cfg.n_kv_heads
        self.ln1 = nn.Parameter(torch.empty(d))
        self.ln2 = nn.Parameter(torch.empty(d))
        self.wq = nn.Linear(d, H * hd, bias=cfg.qkv_bias)
        self.wk = nn.Linear(d, Hkv * hd, bias=cfg.qkv_bias)
        self.wv = nn.Linear(d, Hkv * hd, bias=cfg.qkv_bias)
        self.wo = nn.Linear(H * hd, d, bias=False)
        self.wg = nn.Linear(d, cfg.d_ff, bias=False)
        self.wu = nn.Linear(d, cfg.d_ff, bias=False)
        self.wd = nn.Linear(cfg.d_ff, d, bias=False)
        if cfg.qk_norm:
            self.qnorm = nn.Parameter(torch.empty(hd))
            self.knorm = nn.Parameter(torch.empty(hd))


def _qkv(p: Block, x: torch.Tensor, cfg, cos, sin, ctx: Ctx = NOCTX,
         hmask=None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    # the projections split by whole heads: kv heads only where the tensor
    # axis divides them (the weights' own layout)
    kv = _kv_axis(cfg, ctx.axis_size("tensor"))
    q = ctx.constrain(p.wq(x), "batch", "seq", "tensor").view(B, S, -1, hd)
    k = ctx.constrain(p.wk(x), "batch", "seq", kv).view(B, S, -1, hd)
    v = ctx.constrain(p.wv(x), "batch", "seq", kv).view(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm)
        k = rms_norm(k, p.knorm)
    q = apply_rope(q, cos, sin)
    if hmask is not None:
        q = q * hmask[None, None, :, None]
    q = ctx.constrain(q, "batch", "seq", "tensor", None)
    return q, apply_rope(k, cos, sin), v


def _attn_out(p: Block, o: torch.Tensor, ctx: Ctx = NOCTX,
              hmask=None) -> torch.Tensor:
    if hmask is not None:
        o = o * hmask[None, None, :, None]
    return ctx.constrain(p.wo(o.flatten(2)), "batch", "seq", None)


def _group(cfg) -> int:
    return max(cfg.n_heads // cfg.n_kv_heads, 1)


def _block(cfg, cos, sin, use_full_attn: bool, want_cache: bool = False,
           ctx: Ctx = NOCTX, hmask=None):
    """The layer function of :func:`common.scan_blocks`; with
    ``want_cache`` it also outputs the layer's keys and values."""
    g = _group(cfg)

    def fn(carry, p: Block):
        h, extra = carry
        x = rms_norm(h, p.ln1)
        q, k, v = _qkv(p, x, cfg, cos, sin, ctx, hmask)
        if use_full_attn:
            o = attn_full(q, k, v, group_size=g)
        else:
            o = attn_chunked(q, k, v, q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk, group_size=g, ctx=ctx)
        h = h + _attn_out(p, o, ctx, hmask)
        x = rms_norm(h, p.ln2)
        mlp = gated_mlp(x, p.wg.weight, p.wu.weight, p.wd.weight, ctx)
        if not want_cache:
            mlp = ctx.constrain(mlp, "batch", "seq", None)
        h = ctx.constrain(h + mlp, "batch", "seq", None)
        if not want_cache:
            return (h, extra), None
        return (h, extra), (ctx.constrain(k, "batch", "kv_seq", None, None),
                            ctx.constrain(v, "batch", "kv_seq", None, None))
    return fn


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks, final norm and output head."""

    def __init__(self, cfg, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_padded(), cfg.d_model
        self.tok = nn.Embedding(V, d)
        self.out = nn.Linear(d, V, bias=False)
        self.final_norm = nn.Parameter(torch.empty(d))
        self.layers = nn.ModuleList(Block(cfg, tp)
                                    for _ in range(cfg.n_layers))

    def forward(self, batch: dict, ctx: Ctx = NOCTX,
                return_hidden: bool = False, return_cache: bool = False):
        cfg = self.cfg
        h = common.embed_tokens(self, batch["tokens"], ctx)
        h = common.maybe_prepend_embeds(h, batch, ctx)
        S = h.shape[1]
        pos = torch.arange(S, device=h.device)
        cos, sin = rope_tables(pos[None, :], cfg.head_dim, cfg.rope_theta)
        cos, sin = replicated_like(cos, h), replicated_like(sin, h)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        blk = _block(cfg, cos, sin, S <= FULL_ATTN_MAX, return_cache, ctx,
                     hmask)
        h, _, kv = common.scan_blocks(
            blk, h, self.layers,
            remat=(cfg.remat == "block") and not return_cache)
        if return_hidden:
            return h
        logits = common.unembed(self, h, ctx)
        if not return_cache:
            return logits
        return logits, {"k": kv[0], "v": kv[1],
                        "pos": torch.full((), S - 1, dtype=torch.int32,
                                          device=h.device)}

    def decode(self, cache: dict, tokens: torch.Tensor, ctx: Ctx = NOCTX):
        cfg = self.cfg
        B = tokens.shape[0]
        h = common.embed_tokens(self, tokens, ctx)
        pos = cache["pos"] + 1                   # position of the new token
        cos, sin = rope_tables(pos.expand(B, 1), cfg.head_dim,
                               cfg.rope_theta)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        g = _group(cfg)
        ks, vs = [], []
        for i, p in enumerate(self.layers):
            x = rms_norm(h, p.ln1)
            q, k, v = _qkv(p, x, cfg, cos, sin, ctx, hmask)
            # the OLD cache plus an explicit self-token term; the cache is
            # written once, after the layers
            o = attn_decode(q, cache["k"][i], cache["v"][i], pos, k_new=k,
                            v_new=v, ctx=ctx, group_size=g)
            h = h + _attn_out(p, o, ctx, hmask)
            x = rms_norm(h, p.ln2)
            h = h + gated_mlp(x, p.wg.weight, p.wu.weight, p.wd.weight, ctx)
            ks.append(k)
            vs.append(v)
        kc = update_cache(cache["k"], torch.stack(ks), pos, ctx, seq_axis=2)
        vc = update_cache(cache["v"], torch.stack(vs), pos, ctx, seq_axis=2)
        return common.unembed(self, h, ctx), {"k": kc, "v": vc, "pos": pos}


def build(cfg, params, *, dtype=None, device=None,
          tp: int = 1) -> Transformer:
    """A :class:`Transformer` holding ``params`` (a tree in the reference's
    layout, see :func:`param_defs`), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients."""
    return common.build(Transformer, cfg, params, dtype=dtype, device=device,
                        tp=tp)


def forward(params: Transformer, batch: dict, cfg, ctx: Ctx = NOCTX,
            return_cache: bool = False, return_hidden: bool = False):
    """The reference's ``forward(params, batch, cfg)``: logits (B, S, V), or
    the hidden states (B, S, d) before the final norm, or with
    ``return_cache`` the logits and the prefill cache (``k``, ``v``,
    ``pos``).

    A network built by :func:`build` runs in inference mode; one whose
    parameters require gradients (the trainer's) is differentiated through
    while autograd is enabled.  Under ``ctx``'s mesh the network's
    parameters are ``DTensor``s (``params.distribute``) and so are the
    outputs."""
    return common.forward(params, batch, cfg, ctx,
                          return_hidden=return_hidden,
                          return_cache=return_cache)


def cache_defs(cfg, B: int, S: int) -> dict:
    """Shapes of a decode cache for ``B`` sequences of up to ``S`` tokens
    (the reference's)."""
    hd, Hkv, L = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    return {
        "k": ParamDef((L, B, S, Hkv, hd),
                      ("layers", "batch", "kv_seq", None, None),
                      init="zeros"),
        "v": ParamDef((L, B, S, Hkv, hd),
                      ("layers", "batch", "kv_seq", None, None),
                      init="zeros"),
        "pos": ParamDef((), (), init="zeros"),
    }


def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, cfg,
                ctx: Ctx = NOCTX):
    """One decode step: ``tokens`` (B, 1) at position ``cache["pos"] + 1``
    -> ``(logits (B, 1, V), cache)``; the cache's ``k``/``v`` are updated in
    place and returned with the new ``pos``."""
    return common.decode_step(params, cache, tokens, cfg, ctx)
