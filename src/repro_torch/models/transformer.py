"""Dense decoder-only transformer (llama/qwen family) as an ``nn.Module``.

Covers the dense configs of the reference (qk_norm, QKV bias, GQA); the
port runs smollm-360m.  One :class:`Block` module per layer holds that
layer's parameters under the reference's names (``ln1``, ``wq``, ...), with
projections as ``nn.Linear`` (``models/params.py`` converts the layouts).

Build a model with :func:`build` from a parameter tree in the reference's
layout: :func:`~repro_torch.models.params.init_params` over
:func:`param_defs` for random weights, or the reference's own tree as numpy
arrays.  :func:`forward` has the reference's signature; with
``return_hidden=True`` it returns the hidden states before the final norm.
Training calls the module itself under autograd (``train/train_state.py``);
with ``cfg.remat == "block"`` each block is recomputed in the backward pass.
Prefill caches and decoding (``return_cache``, ``cache_defs``,
``decode_step``) come with the serving slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import device as device_mod
from repro_torch.models import common
from repro_torch.models.layers import (apply_rope, attn_chunked, attn_full,
                                       gated_mlp, rms_norm, rope_tables)
from repro_torch.models.params import ParamDef, params_from_jax

#: longest sequence attended with materialised scores (the reference's
#: ``use_full`` switch); longer ones take the chunked online softmax
FULL_ATTN_MAX = 2048


def block_defs(cfg, tp: int = 1) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    He = cfg.heads_padded(tp)
    Hkv = cfg.n_kv_heads
    defs = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "wq": ParamDef((d, He, hd), ("embed", "tensor", None), fan_in=d),
        "wk": ParamDef((d, Hkv, hd), ("embed", None, None), fan_in=d),
        "wv": ParamDef((d, Hkv, hd), ("embed", None, None), fan_in=d),
        "wo": ParamDef((He, hd, d), ("tensor", None, "embed"), fan_in=He * hd),
        "wg": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wu": ParamDef((d, cfg.d_ff), ("embed", "tensor"), fan_in=d),
        "wd": ParamDef((cfg.d_ff, d), ("tensor", "embed"), fan_in=cfg.d_ff),
    }
    if cfg.qkv_bias:
        defs.update({
            "bq": ParamDef((He, hd), ("tensor", None), init="zeros"),
            "bk": ParamDef((Hkv, hd), (None, None), init="zeros"),
            "bv": ParamDef((Hkv, hd), (None, None), init="zeros"),
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
    """One decoder layer: pre-norm attention and pre-norm SwiGLU MLP."""

    def __init__(self, cfg):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
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


def _qkv(p: Block, x: torch.Tensor, cfg, cos, sin):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = p.wq(x).view(B, S, -1, hd)
    k = p.wk(x).view(B, S, -1, hd)
    v = p.wv(x).view(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm)
        k = rms_norm(k, p.knorm)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out(p: Block, o: torch.Tensor) -> torch.Tensor:
    return p.wo(o.flatten(2))


def _block(cfg, cos, sin, use_full_attn: bool):
    g = max(cfg.n_heads // cfg.n_kv_heads, 1)

    def fn(h: torch.Tensor, p: Block) -> torch.Tensor:
        x = rms_norm(h, p.ln1)
        q, k, v = _qkv(p, x, cfg, cos, sin)
        if use_full_attn:
            o = attn_full(q, k, v, group_size=g)
        else:
            o = attn_chunked(q, k, v, q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk, group_size=g)
        h = h + _attn_out(p, o)
        x = rms_norm(h, p.ln2)
        return h + gated_mlp(x, p.wg.weight, p.wu.weight, p.wd.weight)
    return fn


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks, final norm and output head."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_padded(), cfg.d_model
        self.tok = nn.Embedding(V, d)
        self.out = nn.Linear(d, V, bias=False)
        self.final_norm = nn.Parameter(torch.empty(d))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))

    def forward(self, batch: dict, return_hidden: bool = False):
        cfg = self.cfg
        h = common.embed_tokens(self, batch["tokens"])
        h = common.maybe_prepend_embeds(h, batch)
        S = h.shape[1]
        pos = torch.arange(S, device=h.device)
        cos, sin = rope_tables(pos[None, :], cfg.head_dim, cfg.rope_theta)
        h = common.scan_blocks(_block(cfg, cos, sin, S <= FULL_ATTN_MAX), h,
                               self.layers, remat=(cfg.remat == "block"))
        if return_hidden:
            return h
        return common.unembed(self, h)


def build(cfg, params, *, dtype=None, device=None) -> Transformer:
    """A :class:`Transformer` holding ``params`` (a tree in the reference's
    layout, see :func:`param_defs`), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients."""
    dev = device_mod.resolve(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    model.load_state_dict(params_from_jax(params, dtype=dtype, device=dev),
                          strict=True, assign=True)
    return model.requires_grad_(False).eval()


def forward(params: Transformer, batch: dict, cfg,
            return_hidden: bool = False):
    """The reference's ``forward(params, batch, cfg)``: logits (B, S, V), or
    the hidden states (B, S, d) before the final norm.

    A network built by :func:`build` runs in inference mode; one whose
    parameters require gradients (the trainer's) is differentiated through
    while autograd is enabled."""
    if params.cfg != cfg:
        raise ValueError(f"the model was built for {params.cfg.name!r}, "
                         f"not {cfg.name!r}")
    trains = torch.is_grad_enabled() and params.out.weight.requires_grad
    with torch.inference_mode(not trains):
        return params(batch, return_hidden=return_hidden)
