"""Shared model plumbing: embeddings, the loop over layers, head padding.

The reference's models are pure functions over parameter pytrees with a
``lax.scan`` over layer-stacked parameters; here a model is an
``nn.Module`` whose parameters carry the same names (see
``models/params.py`` for the hand-over), and the scan is a plain loop over
one block module per layer.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.models import layers
from repro_torch.models.layers import NOCTX, Ctx, rms_norm
from repro_torch.models.params import ParamDef, params_from_jax


def embed_defs(cfg) -> dict:
    V = cfg.vocab_padded()
    return {
        "tok": ParamDef((V, cfg.d_model), ("tensor", "embed")),
        "out": ParamDef((cfg.d_model, V), ("embed", "tensor")),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def embed_tokens(model, tokens: torch.Tensor,
                 ctx: Ctx = NOCTX) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, d) in the parameters' dtype.

    Under a mesh the lookup is a local region: each rank looks its tokens
    up in its rows of the table (the vocabulary axis stays split, the
    model axis is gathered), zeros for ids outside them, and the partial
    rows are summed over the vocabulary's mesh axes (the reference's
    GSPMD gather of a vocabulary-sharded table)."""
    if ctx.mesh is None:
        return F.embedding(tokens, model.tok.weight)
    mesh = ctx.mesh
    w = model.tok.weight
    w = w.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                              for pl in w.placements])
    ids = ctx.constrain(tokens, "batch", "seq")
    # ranks along the tokens' mesh axes look up different rows
    w_loc = layers.to_local(w, {i for i, p in enumerate(ids.placements)
                                if isinstance(p, Shard)})
    local = ids.to_local() - layers.local_offset(w, 0)
    inb = (local >= 0) & (local < w_loc.shape[0])
    h = F.embedding(local.clamp(0, max(w_loc.shape[0] - 1, 0)), w_loc)
    h = h * inb[..., None].to(h.dtype)
    part = [wp == Shard(0) for wp in w.placements]
    pl = [Partial() if p else ip for p, ip in zip(part, ids.placements)]
    # each rank's rows enter the sum once: their gradient is the whole one
    grad_pl = [Replicate() if p else ip for p, ip in zip(part, ids.placements)]
    h = layers.from_local(h, mesh, pl, tuple(ids.shape) + (w.shape[1],),
                          grad_placements=grad_pl)
    return ctx.constrain(h, "batch", "seq", None)


def shard_batch(batch: dict, ctx: Ctx) -> dict:
    """A batch's arrays laid out by their batch axis (the reference's
    ``in_shardings`` of a step's batch); unchanged without a mesh."""
    if ctx.mesh is None:
        return batch
    return {k: ctx.constrain(v, "batch", *(None,) * (v.ndim - 1))
            if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def maybe_prepend_embeds(h: Optional[torch.Tensor], batch: dict,
                         ctx: Ctx = NOCTX):
    """Modality frontend stub: precomputed frame/patch embeddings are
    prepended to (or replace) the token embeddings."""
    embeds = batch.get("embeds")
    if embeds is None:
        return h
    if h is None:
        return embeds
    return torch.cat([embeds.to(h.dtype), h], dim=1)


def unembed(model, h: torch.Tensor, ctx: Ctx = NOCTX) -> torch.Tensor:
    """Final norm and the output projection: (B, S, d) -> logits (B, S, V)."""
    logits = F.linear(rms_norm(h, model.final_norm), model.out.weight)
    return ctx.constrain(logits, "batch", "seq", "tensor")


def head_mask(cfg, tp: int, dtype=torch.bfloat16, device=None, like=None):
    """1 for real heads, 0 for tensor-parallel padding heads (None if no
    padding: always on one card, ``tp = 1``); replicated on the mesh of
    ``like`` if that is a ``DTensor``."""
    He = cfg.heads_padded(tp)
    if He == cfg.n_heads:
        return None
    m = (torch.arange(He, device=device) < cfg.n_heads).to(dtype)
    return m if like is None else layers.replicated_like(m, like)


def _stack(ys: list):
    """Per-layer outputs stacked on a new leading (layers) axis: a tuple of
    stacks for tuple outputs, None when the blocks output nothing."""
    if not ys or ys[0] is None:
        return None
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(c) for c in zip(*ys))
    return torch.stack(ys)


def scan_blocks(block_fn: Callable, h: torch.Tensor, blocks, *,
                remat: bool = False, carry_extra=None):
    """Apply ``block_fn((h, extra), block) -> ((h, extra), ys)`` for each
    block in order (the reference's ``lax.scan`` over layer-stacked
    parameters); returns ``(h, extra, ys)``, with ``ys`` the blocks'
    per-layer outputs stacked along a leading layers axis (the prefill
    caches; None when the blocks output None).  ``carry_extra`` is carried
    from block to block (the MoE aux loss).

    ``remat``: while gradients are recorded, each block saves only its
    input and recomputes its activations in the backward pass (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    remat = remat and torch.is_grad_enabled()
    carry = (h, carry_extra)
    ys = []
    for blk in blocks:
        if remat:
            carry, y = checkpoint(block_fn, carry, blk, use_reentrant=False)
        else:
            carry, y = block_fn(carry, blk)
        ys.append(y)
    return carry[0], carry[1], _stack(ys)


def seq_indexed(key: str) -> bool:
    """Cache entries indexed by position along axis 2: the KV caches and
    MLA's latents (an SSM's ``conv`` window and ``state`` are not)."""
    return key in ("k", "v") or key.endswith("ckv") or key.endswith("kr")


def grow_cache(cache: dict, length: int) -> dict:
    """A prefill cache with room to decode: the sequence-indexed entries
    (``k``, ``v``, ``*ckv``, ``*kr``, ``(L, B, S, ...)``) zero-padded along
    their length axis to ``length``; every other entry unchanged.  (The
    reference pads its caches the same way before decoding,
    ``tests/test_models_smoke.py``.)"""
    out = {}
    for k, v in cache.items():
        if isinstance(v, torch.Tensor) and seq_indexed(k):
            pad = v.new_zeros(v.shape[:2] + (length - v.shape[2],)
                              + v.shape[3:])
            v = torch.cat([v, pad], dim=2)
        out[k] = v
    return out


def cache_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of cache entry ``key`` of a model run in ``dtype``: ``pos``
    int32, an SSM ``state`` f32 (as a prefill leaves it: a state kept in
    ``dtype`` is another recurrence), every other entry ``dtype``."""
    return {"pos": torch.int32, "state": torch.float32}.get(key, dtype)


def init_cache(defs: dict, dtype: torch.dtype, device=None) -> dict:
    """Zeros of a model's ``cache_defs`` in :func:`cache_dtype`'s dtypes;
    None entries stay None."""
    out = {}
    for k, d in defs.items():
        if d is None:
            out[k] = None
            continue
        out[k] = torch.zeros(d.shape, dtype=cache_dtype(k, dtype),
                             device=device)
    return out


def build(model_cls, cfg, params, *, dtype=None, device=None, tp: int = 1):
    """A ``model_cls(cfg, tp)`` network holding ``params`` (a tree in the
    reference's layout, the model module's ``param_defs(cfg, tp)``: heads
    padded to a multiple of ``tp``), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients.  Each
    model module's ``build`` is this with its class."""
    dev = device_mod.resolve(device)
    with torch.device("meta"):
        model = model_cls(cfg, tp)
    model.load_state_dict(params_from_jax(params, dtype=dtype, device=dev),
                          strict=True, assign=True)
    return model.requires_grad_(False).eval()


def _check(params, cfg) -> None:
    if params.cfg != cfg:
        raise ValueError(f"the model was built for {params.cfg.name!r}, "
                         f"not {cfg.name!r}")


def _no_grad(ctx: Ctx, enabled: bool = True):
    """Inference mode, or under a mesh ``no_grad`` (a view of a ``DTensor``
    made outside inference mode cannot be taken inside it)."""
    if ctx.mesh is None:
        return torch.inference_mode(enabled)
    return torch.no_grad() if enabled else contextlib.nullcontext()


def forward(params, batch: dict, cfg, ctx: Ctx = NOCTX, **kw):
    """``params(batch, ctx, **kw)`` for a network built for ``cfg``: in
    inference mode unless its parameters require gradients and autograd is
    enabled (the trainer's network).  Under a mesh the batch is laid out
    by its batch axis first."""
    _check(params, cfg)
    trains = torch.is_grad_enabled() and params.out.weight.requires_grad
    with ctx.scope(), _no_grad(ctx, not trains):
        return params(shard_batch(batch, ctx), ctx, **kw)


def decode_step(params, cache: dict, tokens: torch.Tensor, cfg,
                ctx: Ctx = NOCTX):
    """``params.decode(cache, tokens, ctx)`` in inference mode, for a
    network built for ``cfg``."""
    _check(params, cfg)
    with ctx.scope(), _no_grad(ctx):
        return params.decode(cache, ctx.constrain(tokens, "batch", None),
                             ctx)


def stack_layer_defs(defs: dict, n_layers: int) -> dict:
    """Prepend a 'layers' axis to every ParamDef in a block's def tree."""
    return {k: (stack_layer_defs(v, n_layers) if isinstance(v, dict) else
                ParamDef((n_layers,) + v.shape, ("layers",) + v.axes,
                         init=v.init, fan_in=v.fan_in))
            for k, v in defs.items()}
