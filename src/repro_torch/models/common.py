"""Shared model plumbing: embeddings, the loop over layers, head padding.

The reference's models are pure functions over parameter pytrees with a
``lax.scan`` over layer-stacked parameters; here a model is an
``nn.Module`` whose parameters carry the same names (see
``models/params.py`` for the hand-over), and the scan is a plain loop over
one block module per layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDef


def embed_defs(cfg) -> dict:
    V = cfg.vocab_padded()
    return {
        "tok": ParamDef((V, cfg.d_model), ("tensor", "embed")),
        "out": ParamDef((cfg.d_model, V), ("embed", "tensor")),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def embed_tokens(model, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> embeddings (B, S, d) in the parameters' dtype."""
    return F.embedding(tokens, model.tok.weight)


def maybe_prepend_embeds(h: Optional[torch.Tensor], batch: dict):
    """Modality frontend stub: precomputed frame/patch embeddings are
    prepended to (or replace) the token embeddings."""
    embeds = batch.get("embeds")
    if embeds is None:
        return h
    if h is None:
        return embeds
    return torch.cat([embeds.to(h.dtype), h], dim=1)


def unembed(model, h: torch.Tensor) -> torch.Tensor:
    """Final norm and the output projection: (B, S, d) -> logits (B, S, V)."""
    return F.linear(rms_norm(h, model.final_norm), model.out.weight)


def head_mask(cfg, tp: int, dtype=torch.bfloat16, device=None):
    """1 for real heads, 0 for tensor-parallel padding heads (None if no
    padding; always None on one card, ``tp = 1``)."""
    He = cfg.heads_padded(tp)
    if He == cfg.n_heads:
        return None
    return (torch.arange(He, device=device) < cfg.n_heads).to(dtype)


def scan_blocks(block_fn: Callable, h: torch.Tensor, blocks, *,
                remat: bool = False) -> torch.Tensor:
    """Apply ``block_fn(h, block)`` for each block in order (the
    reference's ``lax.scan`` over layer-stacked parameters).

    ``remat``: while gradients are recorded, each block saves only its
    input and recomputes its activations in the backward pass (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        if remat:
            h = checkpoint(block_fn, h, blk, use_reentrant=False)
        else:
            h = block_fn(h, blk)
    return h


def stack_layer_defs(defs: dict, n_layers: int) -> dict:
    """Prepend a 'layers' axis to every ParamDef in a block's def tree."""
    return {k: (stack_layer_defs(v, n_layers) if isinstance(v, dict) else
                ParamDef((n_layers,) + v.shape, ("layers",) + v.axes,
                         init=v.init, fan_in=v.fan_in))
            for k, v in defs.items()}
