"""Zamba2-style hybrid as an ``nn.Module``: a Mamba2 backbone with ONE
shared attention + MLP block applied after every complete group of
``attn_every`` SSM layers (the same weights at every application).

The SSM layers are ``mamba2.SSMBlock``s under ``layers``; the shared block
is a dense ``transformer.Block`` under ``shared`` (the reference's
top-level ``shared`` subtree, not a layer stack).  A depth that is no
multiple of ``attn_every`` ends in an incomplete group that runs after the
last application (zamba2-1.2b: 38 = 6 x 6 + 2 layers, 6 applications).

Decoding: the prefill cache holds the SSM layers' ``conv`` and ``state``
(layer-stacked over all groups, as in ``mamba2``) and one KV cache per
application, ``k``/``v`` ``(n_applications, B, S, Hkv, hd)``.  A decode
step advances the SSM layers in place, attends each application's OLD KV
cache plus its own new key and value (``layers.attn_decode``), and writes
the new keys and values once, after the layers (``layers.update_cache``).
The KV caches must have room: ``common.grow_cache`` or
``common.init_cache`` over :func:`cache_defs`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common, mamba2, transformer
from repro_torch.models.layers import (NOCTX, Ctx, attn_chunked, attn_decode,
                                       attn_full, gated_mlp, replicated_like,
                                       rms_norm, rope_tables, update_cache)
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import FULL_ATTN_MAX


def n_applications(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def param_defs(cfg, tp: int = 1) -> dict:
    return {
        **common.embed_defs(cfg),
        "layers": common.stack_layer_defs(mamba2.block_defs(cfg, tp),
                                          cfg.n_layers),
        "shared": transformer.block_defs(cfg, tp),   # ONE shared block
    }


def _groups(cfg):
    """``(first layer, end layer, complete)`` for each group of
    ``attn_every`` SSM layers; the shared block runs after each complete
    one."""
    k, n = cfg.attn_every, cfg.n_layers
    return [(s, min(s + k, n), min(s + k, n) - s == k)
            for s in range(0, n, k)]


def _shared_block(p: transformer.Block, h, cfg, cos, sin, kc=None, vc=None,
                  pos=None, ctx: Ctx = NOCTX, hmask=None):
    """The shared attention + MLP block (transformer semantics); with a KV
    cache one decode step against it.  Returns ``(h, (k, v))``, the keys
    and values of ``h``'s positions."""
    x = rms_norm(h, p.ln1)
    q, k, v = transformer._qkv(p, x, cfg, cos, sin, ctx, hmask)
    g = transformer._group(cfg)
    if kc is not None:
        o = attn_decode(q, kc, vc, pos, k_new=k, v_new=v, ctx=ctx,
                        group_size=g)
    elif h.shape[1] <= FULL_ATTN_MAX:
        o = attn_full(q, k, v, group_size=g)
    else:
        o = attn_chunked(q, k, v, q_chunk=cfg.attn_chunk,
                         kv_chunk=cfg.attn_chunk, group_size=g, ctx=ctx)
    h = h + transformer._attn_out(p, o, ctx, hmask)
    x = rms_norm(h, p.ln2)
    mlp = gated_mlp(x, p.wg.weight, p.wu.weight, p.wd.weight, ctx)
    return h + ctx.constrain(mlp, "batch", "seq", None), (k, v)


class HybridModel(nn.Module):
    """Embedding, the SSM layers, the shared block, final norm and head."""

    def __init__(self, cfg, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_padded(), cfg.d_model
        self.tok = nn.Embedding(V, d)
        self.out = nn.Linear(d, V, bias=False)
        self.final_norm = nn.Parameter(torch.empty(d))
        self.layers = nn.ModuleList(mamba2.SSMBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.shared = transformer.Block(cfg, tp)

    def forward(self, batch: dict, ctx: Ctx = NOCTX,
                return_hidden: bool = False, return_cache: bool = False):
        cfg = self.cfg
        h = common.embed_tokens(self, batch["tokens"], ctx)
        h = common.maybe_prepend_embeds(h, batch, ctx)
        S = h.shape[1]
        cos, sin = rope_tables(torch.arange(S, device=h.device)[None, :],
                               cfg.head_dim, cfg.rope_theta)
        cos, sin = replicated_like(cos, h), replicated_like(sin, h)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        remat = (cfg.remat == "block") and not return_cache
        fn = mamba2._ssm_fn(cfg, return_cache, ctx)
        ssm, kvs = [], []
        for g0, g1, complete in _groups(cfg):
            h, _, ys = common.scan_blocks(fn, h, self.layers[g0:g1],
                                          remat=remat)
            ssm.append(ys)
            if complete:
                h, kv = _shared_block(self.shared, h, cfg, cos, sin, ctx=ctx,
                                      hmask=hmask)
                kvs.append(kv)
        if return_hidden:
            return h
        logits = common.unembed(self, h, ctx)
        if not return_cache:
            return logits

        def kv_seq(t):
            return ctx.constrain(t, "batch", "kv_seq", None, None)
        return logits, {
            "conv": torch.cat([c for c, _ in ssm]),
            "state": torch.cat([s for _, s in ssm]),
            "k": torch.stack([kv_seq(k) for k, _ in kvs]),
            "v": torch.stack([kv_seq(v) for _, v in kvs]),
            "pos": torch.full((), S - 1, dtype=torch.int32, device=h.device)}

    def decode(self, cache: dict, tokens: torch.Tensor, ctx: Ctx = NOCTX):
        cfg = self.cfg
        B = tokens.shape[0]
        h = common.embed_tokens(self, tokens, ctx)
        pos = cache["pos"] + 1                   # position of the new token
        cos, sin = rope_tables(pos.expand(B, 1), cfg.head_dim,
                               cfg.rope_theta)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        ks, vs = [], []
        for g0, g1, complete in _groups(cfg):
            h = mamba2.decode_layers(self.layers[g0:g1], h, cache, cfg, g0,
                                     ctx)
            if complete:
                app = len(ks)
                h, (k, v) = _shared_block(self.shared, h, cfg, cos, sin,
                                          cache["k"][app], cache["v"][app],
                                          pos, ctx, hmask)
                ks.append(k)
                vs.append(v)
        kc = update_cache(cache["k"], torch.stack(ks), pos, ctx, seq_axis=2)
        vc = update_cache(cache["v"], torch.stack(vs), pos, ctx, seq_axis=2)
        return common.unembed(self, h, ctx), {**cache, "k": kc, "v": vc,
                                              "pos": pos}


def cache_defs(cfg, B: int, S: int) -> dict:
    """Shapes of a decode cache for ``B`` sequences of up to ``S`` tokens
    (the reference's): mamba2's conv windows and states, and a KV cache
    per application of the shared block."""
    defs = mamba2.cache_defs(cfg, B, S)
    kv = ParamDef((n_applications(cfg), B, S, cfg.n_kv_heads, cfg.head_dim),
                  (None, "batch", "kv_seq", None, None), init="zeros")
    return {**defs, "k": kv, "v": kv}


def build(cfg, params, *, dtype=None, device=None,
          tp: int = 1) -> HybridModel:
    """A :class:`HybridModel` holding ``params`` (a tree in the reference's
    layout, see :func:`param_defs`), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients."""
    return common.build(HybridModel, cfg, params, dtype=dtype, device=device,
                        tp=tp)


def forward(params: HybridModel, batch: dict, cfg, ctx: Ctx = NOCTX,
            return_cache: bool = False, return_hidden: bool = False):
    """The reference's ``forward(params, batch, cfg)``: logits, hidden
    states before the final norm, or with ``return_cache`` the logits and
    the prefill cache (``conv``, ``state``, ``k``, ``v``, ``pos``)."""
    return common.forward(params, batch, cfg, ctx,
                          return_hidden=return_hidden,
                          return_cache=return_cache)


def decode_step(params: HybridModel, cache: dict, tokens: torch.Tensor, cfg,
                ctx: Ctx = NOCTX):
    """One decode step: ``tokens`` (B, 1) at position ``cache["pos"] + 1``
    -> ``(logits (B, 1, V), cache)``; every cache entry is updated in place
    and returned with the new ``pos``."""
    return common.decode_step(params, cache, tokens, cfg, ctx)
