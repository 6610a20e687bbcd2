"""MoE decoder with Multi-head Latent Attention (DeepSeek-V2 / Kimi-K2) as
an ``nn.Module``.

MLA: queries optionally low-rank (``q_lora``); keys and values decompressed
from a shared compressed latent ``c_kv`` (``kv_lora``) plus one shared RoPE
key head.  The decode cache holds only the latents (``c_kv``, ``k_rope``),
and decoding uses the *absorbed* form: scores and context in latent space,
``W_uk``/``W_uv`` folded into the query and output transforms
(:func:`_mla_decode_attn`).  Train and prefill use the decompressed form
(:func:`_mla_qkv`).

MoE: token-choice top-k routing with capacity dispatch over every expert
(``layers.moe_block``); shared experts and the first
``first_dense_layers`` dense blocks run as plain SwiGLU.  Under a mesh
(``Ctx``) the routed experts run expert-parallel over ``model``
(``layers.moe_block``'s local region, the reference's ``shard_map``
branch).

One :class:`MLABlock` per layer holds that layer's parameters under the
reference's names: projections as ``nn.Linear``, the expert stacks
``w_gate``/``w_up``/``w_down`` as parameters in the reference's ``(E, in,
out)`` layout, the shared experts as a ``shared`` submodule.
:func:`forward` returns ``(logits, aux)`` (the summed MoE aux loss), or
``(logits, aux, cache)`` with ``return_cache``; :func:`decode_step` has the
dense transformer's ``pos`` convention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.layers import (NOCTX, Ctx, apply_rope, attn_chunked,
                                       attn_full, gated_mlp, masked,
                                       moe_block, replicated_like, rms_norm,
                                       rope_tables, softmax_with_self,
                                       update_cache)
from repro_torch.models.params import ParamDef
from repro_torch.models.transformer import FULL_ATTN_MAX


def mla_defs(cfg, tp: int = 1) -> dict:
    d = cfg.d_model
    H = cfg.heads_padded(tp)
    qh = cfg.nope_head_dim + cfg.rope_head_dim
    defs = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "wo": ParamDef((H, cfg.v_head_dim, d), ("tensor", None, "embed"),
                       fan_in=H * cfg.v_head_dim),
        "wdkv": ParamDef((d, cfg.kv_lora), ("embed", None), fan_in=d),
        "kv_norm": ParamDef((cfg.kv_lora,), (None,), init="ones"),
        "wkr": ParamDef((d, cfg.rope_head_dim), ("embed", None), fan_in=d),
        "wuk": ParamDef((cfg.kv_lora, H, cfg.nope_head_dim),
                        (None, "tensor", None), fan_in=cfg.kv_lora),
        "wuv": ParamDef((cfg.kv_lora, H, cfg.v_head_dim),
                        (None, "tensor", None), fan_in=cfg.kv_lora),
    }
    if cfg.q_lora:
        defs.update({
            "wdq": ParamDef((d, cfg.q_lora), ("embed", None), fan_in=d),
            "q_norm": ParamDef((cfg.q_lora,), (None,), init="ones"),
            "wuq": ParamDef((cfg.q_lora, H, qh), (None, "tensor", None),
                            fan_in=cfg.q_lora),
        })
    else:
        defs["wq"] = ParamDef((d, H, qh), ("embed", "tensor", None), fan_in=d)
    return defs


def dense_mlp_defs(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln2": ParamDef((d,), (None,), init="ones"),
        "wg": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wu": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wd": ParamDef((cfg.d_ff, d), ("tensor", "embed"), fan_in=cfg.d_ff),
    }


def moe_mlp_defs(cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    fs = f * cfg.n_shared_experts
    defs = {
        "ln2": ParamDef((d,), (None,), init="ones"),
        "router": ParamDef((d, E), (None, None), fan_in=d),
        "w_gate": ParamDef((E, d, f), ("experts", "embed", None), fan_in=d),
        "w_up": ParamDef((E, d, f), ("experts", "embed", None), fan_in=d),
        "w_down": ParamDef((E, f, d), ("experts", None, "embed"), fan_in=f),
    }
    if cfg.n_shared_experts:
        defs["shared"] = {
            "wg": ParamDef((d, fs), ("embed", "tensor"), fan_in=d),
            "wu": ParamDef((d, fs), ("embed", "tensor"), fan_in=d),
            "wd": ParamDef((fs, d), ("tensor", "embed"), fan_in=fs),
        }
    return defs


def param_defs(cfg, tp: int = 1) -> dict:
    nd = cfg.first_dense_layers
    defs = {
        **common.embed_defs(cfg),
        "moe_layers": common.stack_layer_defs(
            {**mla_defs(cfg, tp), **moe_mlp_defs(cfg)}, cfg.n_layers - nd),
    }
    if nd > 0:
        defs["dense_layers"] = common.stack_layer_defs(
            {**mla_defs(cfg, tp), **dense_mlp_defs(cfg)}, nd)
    return defs


class _SwiGLU(nn.Module):
    """The shared experts: one SwiGLU of width ``moe_d_ff *
    n_shared_experts``."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.wg = nn.Linear(d, f, bias=False)
        self.wu = nn.Linear(d, f, bias=False)
        self.wd = nn.Linear(f, d, bias=False)


class MLABlock(nn.Module):
    """One decoder layer: pre-norm MLA (heads padded to a multiple of
    ``tp``), then a pre-norm dense SwiGLU (``moe=False``) or MoE layer."""

    def __init__(self, cfg, moe: bool, tp: int = 1):
        super().__init__()
        d, H, r = cfg.d_model, cfg.heads_padded(tp), cfg.kv_lora
        self.n_heads = H
        nope, rope_d, vd = (cfg.nope_head_dim, cfg.rope_head_dim,
                            cfg.v_head_dim)
        self.ln1 = nn.Parameter(torch.empty(d))
        self.wo = nn.Linear(H * vd, d, bias=False)
        self.wdkv = nn.Linear(d, r, bias=False)
        self.kv_norm = nn.Parameter(torch.empty(r))
        self.wkr = nn.Linear(d, rope_d, bias=False)
        self.wuk = nn.Linear(r, H * nope, bias=False)
        self.wuv = nn.Linear(r, H * vd, bias=False)
        if cfg.q_lora:
            self.wdq = nn.Linear(d, cfg.q_lora, bias=False)
            self.q_norm = nn.Parameter(torch.empty(cfg.q_lora))
            self.wuq = nn.Linear(cfg.q_lora, H * (nope + rope_d), bias=False)
        else:
            self.wq = nn.Linear(d, H * (nope + rope_d), bias=False)
        self.ln2 = nn.Parameter(torch.empty(d))
        if not moe:
            self.wg = nn.Linear(d, cfg.d_ff, bias=False)
            self.wu = nn.Linear(d, cfg.d_ff, bias=False)
            self.wd = nn.Linear(cfg.d_ff, d, bias=False)
            return
        E, f = cfg.n_experts, cfg.moe_d_ff
        self.router = nn.Linear(d, E, bias=False)
        self.w_gate = nn.Parameter(torch.empty(E, d, f))
        self.w_up = nn.Parameter(torch.empty(E, d, f))
        self.w_down = nn.Parameter(torch.empty(E, f, d))
        if cfg.n_shared_experts:
            self.shared = _SwiGLU(d, f * cfg.n_shared_experts)


def _queries(p: MLABlock, x: torch.Tensor, cfg, cos, sin):
    """``(q_nope, q_rope)`` of x ``(B, S, d)``, RoPE applied to the second."""
    B, S, _ = x.shape
    if cfg.q_lora:
        q = p.wuq(rms_norm(p.wdq(x), p.q_norm))
    else:
        q = p.wq(x)
    q = q.view(B, S, p.n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    nope = cfg.nope_head_dim
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _latents(p: MLABlock, x: torch.Tensor, cos, sin):
    """The token's cache entries: ``c_kv`` ``(B, S, kv_lora)`` and the
    shared roped key head ``k_rope`` ``(B, S, rope_head_dim)``."""
    ckv = rms_norm(p.wdkv(x), p.kv_norm)
    k_rope = apply_rope(p.wkr(x)[:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, k_rope


def _mla_qkv(p: MLABlock, x: torch.Tensor, cfg, cos, sin, ctx: Ctx = NOCTX,
             hmask=None):
    """Full (decompressed) MLA q/k/v for train and prefill, and the
    latents the cache keeps."""
    B, S, _ = x.shape
    H = p.n_heads
    q_nope, q_rope = _queries(p, x, cfg, cos, sin)
    ckv, k_rope = _latents(p, x, cos, sin)
    k_nope = p.wuk(ckv).view(B, S, H, cfg.nope_head_dim)
    v = p.wuv(ckv).view(B, S, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if hmask is not None:
        q = q * hmask[None, None, :, None]
    q = ctx.constrain(q, "batch", "seq", "tensor", None)
    return q, k, v, ckv, k_rope


def _attn_out(p: MLABlock, o: torch.Tensor, ctx: Ctx = NOCTX,
              hmask=None) -> torch.Tensor:
    if hmask is not None:
        o = o * hmask[None, None, :, None]
    return ctx.constrain(p.wo(o.flatten(2)), "batch", "seq", None)


def _mla_block(p: MLABlock, h, cfg, cos, sin, use_full: bool,
               ctx: Ctx = NOCTX, hmask=None):
    x = rms_norm(h, p.ln1)
    q, k, v, ckv, krope = _mla_qkv(p, x, cfg, cos, sin, ctx, hmask)
    if use_full:
        o = attn_full(q, k, v)
    else:
        o = attn_chunked(q, k, v, q_chunk=cfg.attn_chunk,
                         kv_chunk=cfg.attn_chunk, ctx=ctx)
    return h + _attn_out(p, o, ctx, hmask), (
        ctx.constrain(ckv, "batch", "kv_seq", None),
        ctx.constrain(krope, "batch", "kv_seq", None))


def _mla_decode_attn(p: MLABlock, x, ckv_c, kr_c, pos, cfg, cos, sin,
                     ctx: Ctx = NOCTX, hmask=None):
    """Absorbed-MLA decode: scores and context in latent space.

    Reads the OLD latent cache (``(B, S, kv_lora)``, ``(B, S, rope)``,
    masked at ``>= pos``) plus an explicit self-token term; returns the
    attention output and the new token's latents for the cache write."""
    nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    H, r = p.n_heads, cfg.kv_lora
    q_nope, q_rope = _queries(p, x, cfg, cos, sin)
    if hmask is not None:
        q_nope = q_nope * hmask[None, None, :, None]
        q_rope = q_rope * hmask[None, None, :, None]
    ckv_new, kr_new = _latents(p, x, cos, sin)
    scale = 1.0 / math.sqrt(nope + rope_d)
    # q_nope into latent space once per step: wuk as (H, nope, r)
    q_lat = torch.einsum("bshk,hkr->bshr", q_nope,
                         p.wuk.weight.view(H, nope, r))
    s = torch.einsum("bshr,btr->bhst", q_lat, ckv_c) \
        + torch.einsum("bshk,btk->bhst", q_rope, kr_c)
    s = ctx.constrain(s.to(torch.float32) * scale, "batch", None, None,
                      "kv_seq")
    mask = torch.arange(ckv_c.shape[1], device=x.device) < pos
    s = masked(mask, s)
    s_self = (torch.einsum("bshr,btr->bhst", q_lat, ckv_new)
              + torch.einsum("bshk,btk->bhst", q_rope, kr_new)
              ).to(torch.float32) * scale
    w_c, w_s = softmax_with_self(s, s_self)
    ctx_lat = torch.einsum("bhst,btr->bshr", w_c.to(ckv_c.dtype), ckv_c)
    ctx_lat = ctx_lat + torch.einsum("bhst,btr->bshr",
                                     w_s.to(ckv_new.dtype), ckv_new)
    o = torch.einsum("bshr,hvr->bshv", ctx_lat,
                     p.wuv.weight.view(H, vd, r))
    return o, ckv_new, kr_new


def _dense_mlp(p: MLABlock, h, ctx: Optional[Ctx] = None):
    """The dense SwiGLU sublayer; with ``ctx`` its Megatron schedule pinned
    and its output laid out like ``h`` (train and prefill)."""
    x = rms_norm(h, p.ln2)
    mlp = gated_mlp(x, p.wg.weight, p.wu.weight, p.wd.weight, ctx)
    if ctx is not None:
        mlp = ctx.constrain(mlp, "batch", "seq", None)
    return h + mlp


def _moe_mlp(p: MLABlock, h, cfg, ctx: Ctx = NOCTX, constrain: bool = True):
    mo, aux = moe_block(p, rms_norm(h, p.ln2), cfg, ctx)
    if constrain:
        mo = ctx.constrain(mo, "batch", "seq", None)
    return h + mo, aux


class MoEModel(nn.Module):
    """Embedding, ``first_dense_layers`` dense MLA blocks, the MoE MLA
    blocks, final norm and output head."""

    def __init__(self, cfg, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_padded(), cfg.d_model
        nd = cfg.first_dense_layers
        self.tok = nn.Embedding(V, d)
        self.out = nn.Linear(d, V, bias=False)
        self.final_norm = nn.Parameter(torch.empty(d))
        self.dense_layers = nn.ModuleList(MLABlock(cfg, moe=False, tp=tp)
                                          for _ in range(nd))
        self.moe_layers = nn.ModuleList(MLABlock(cfg, moe=True, tp=tp)
                                        for _ in range(cfg.n_layers - nd))

    def forward(self, batch: dict, ctx: Ctx = NOCTX,
                return_hidden: bool = False, return_cache: bool = False):
        cfg = self.cfg
        h = common.embed_tokens(self, batch["tokens"], ctx)
        h = common.maybe_prepend_embeds(h, batch, ctx)
        S = h.shape[1]
        cos, sin = rope_tables(torch.arange(S, device=h.device)[None, :],
                               cfg.rope_head_dim, cfg.rope_theta)
        cos, sin = replicated_like(cos, h), replicated_like(sin, h)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        use_full = S <= FULL_ATTN_MAX

        def dense_blk(carry, p):
            h, aux = carry
            h, cache = _mla_block(p, h, cfg, cos, sin, use_full, ctx, hmask)
            return (_dense_mlp(p, h, ctx), aux), \
                (cache if return_cache else None)

        def moe_blk(carry, p):
            h, aux = carry
            h, cache = _mla_block(p, h, cfg, cos, sin, use_full, ctx, hmask)
            h, a = _moe_mlp(p, h, cfg, ctx)
            return (h, aux + a), (cache if return_cache else None)

        remat = (cfg.remat == "block") and not return_cache
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        h, aux, dense = common.scan_blocks(dense_blk, h, self.dense_layers,
                                           remat=remat, carry_extra=aux)
        h, aux, moe = common.scan_blocks(moe_blk, h, self.moe_layers,
                                         remat=remat, carry_extra=aux)
        if return_hidden:
            return h
        logits = common.unembed(self, h, ctx)
        if not return_cache:
            return logits, aux
        return logits, aux, {
            "dense_ckv": dense[0] if dense else None,
            "dense_kr": dense[1] if dense else None,
            "moe_ckv": moe[0], "moe_kr": moe[1],
            "pos": torch.full((), S - 1, dtype=torch.int32,
                              device=h.device)}

    def decode(self, cache: dict, tokens: torch.Tensor, ctx: Ctx = NOCTX):
        cfg = self.cfg
        B = tokens.shape[0]
        h = common.embed_tokens(self, tokens, ctx)
        pos = cache["pos"] + 1
        cos, sin = rope_tables(pos.expand(B, 1), cfg.rope_head_dim,
                               cfg.rope_theta)
        hmask = common.head_mask(cfg, ctx.axis_size("tensor"), h.dtype,
                                 h.device, like=h)
        new_cache = dict(cache)
        for stack, layers in (("dense", self.dense_layers),
                              ("moe", self.moe_layers)):
            if not len(layers):
                continue
            ckv_c, kr_c = cache[f"{stack}_ckv"], cache[f"{stack}_kr"]
            ckvs, krs = [], []
            for i, p in enumerate(layers):
                x = rms_norm(h, p.ln1)
                o, ckv, kr = _mla_decode_attn(p, x, ckv_c[i], kr_c[i], pos,
                                              cfg, cos, sin, ctx, hmask)
                h = h + _attn_out(p, o, ctx, hmask)
                h = _dense_mlp(p, h) if stack == "dense" \
                    else _moe_mlp(p, h, cfg, ctx, constrain=False)[0]
                ckvs.append(ckv)
                krs.append(kr)
            new_cache[f"{stack}_ckv"] = update_cache(
                ckv_c, torch.stack(ckvs), pos, ctx, seq_axis=2)
            new_cache[f"{stack}_kr"] = update_cache(
                kr_c, torch.stack(krs), pos, ctx, seq_axis=2)
        new_cache["pos"] = pos
        return common.unembed(self, h, ctx), new_cache


def cache_defs(cfg, B: int, S: int) -> dict:
    """Shapes of a latent decode cache for ``B`` sequences of up to ``S``
    tokens (the reference's)."""
    nd, L = cfg.first_dense_layers, cfg.n_layers
    r, kr = cfg.kv_lora, cfg.rope_head_dim

    def c(n, dim):
        return ParamDef((n, B, S, dim), ("layers", "batch", "kv_seq", None),
                        init="zeros")
    return {
        "moe_ckv": c(L - nd, r), "moe_kr": c(L - nd, kr),
        "pos": ParamDef((), (), init="zeros"),
        "dense_ckv": c(nd, r) if nd else None,
        "dense_kr": c(nd, kr) if nd else None,
    }


def build(cfg, params, *, dtype=None, device=None, tp: int = 1) -> MoEModel:
    """A :class:`MoEModel` holding ``params`` (a tree in the reference's
    layout, see :func:`param_defs`), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients."""
    return common.build(MoEModel, cfg, params, dtype=dtype, device=device,
                        tp=tp)


def forward(params: MoEModel, batch: dict, cfg, ctx: Ctx = NOCTX,
            return_cache: bool = False, return_hidden: bool = False):
    """The reference's ``forward(params, batch, cfg)``: ``(logits, aux)``;
    with ``return_cache`` ``(logits, aux, cache)`` (``dense_ckv``,
    ``dense_kr``, ``moe_ckv``, ``moe_kr`` ``(L, B, S, ...)`` and ``pos = S -
    1``); with ``return_hidden`` the hidden states before the final norm.
    Inference mode unless the parameters require gradients and autograd is
    enabled (the trainer's network)."""
    return common.forward(params, batch, cfg, ctx,
                          return_hidden=return_hidden,
                          return_cache=return_cache)


def decode_step(params: MoEModel, cache: dict, tokens: torch.Tensor, cfg,
                ctx: Ctx = NOCTX):
    """One absorbed-MLA decode step: ``tokens`` (B, 1) at position
    ``cache["pos"] + 1`` -> ``(logits (B, 1, V), cache)``; the latent caches
    are updated in place and returned with the new ``pos``."""
    return common.decode_step(params, cache, tokens, cfg, ctx)
