"""Mamba2 (state-space duality) decoder, attention-free, as an ``nn.Module``.

Each block: ``w_in`` -> (z | x | B | C | dt), causal depthwise convolution
over (x|B|C) (``layers.causal_conv1d``), softplus dt, the chunked SSD scan
(``layers.ssd_chunked``), the gate ``y * silu(z)`` *before* the RMSNorm
``out_norm`` (the reference's order), ``w_out``.  One :class:`SSMBlock`
per layer holds that layer's parameters under the reference's names
(``ln``, ``w_in``, ``conv_w``, ``A_log``, ``D``, ``dt_bias``, ``out_norm``,
``w_out``), the two projections as ``nn.Linear`` and ``conv_w`` in the
reference's ``(K, C)`` layout.

Decoding keeps O(1) state per layer: ``forward(..., return_cache=True)``
returns ``{"conv" (L, B, K-1, C), "state" (L, B, H, P, N) f32, "pos"}``
(the last ``K-1`` convolution inputs, the SSM state after the prompt, and
``pos = S - 1`` as a 0-d tensor on the card, so no step waits for the
host); :func:`decode_step` advances every layer by one token with
``layers.ssd_step`` and writes the convolution window and the state back
into the cache in place, in the cache's dtypes.  Nothing grows with the
sequence, which is what lets the ``long_500k`` decode cell run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.layers import (NOCTX, Ctx, causal_conv1d, from_local,
                                       rms_norm, ssd_chunked, ssd_step,
                                       to_local)
from repro_torch.models.params import ParamDef


def block_defs(cfg, tp: int = 1) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * G * N
    return {
        "ln": ParamDef((d,), (None,), init="ones"),
        "w_in": ParamDef((d, 2 * di + 2 * G * N + H), ("embed", "tensor"),
                         fan_in=d),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), (None, "tensor")),
        "A_log": ParamDef((H,), ("tensor",), init="zeros"),
        "D": ParamDef((H,), ("tensor",), init="ones"),
        "dt_bias": ParamDef((H,), ("tensor",), init="zeros"),
        "out_norm": ParamDef((di,), ("tensor",), init="ones"),
        "w_out": ParamDef((di, d), ("tensor", "embed"), fan_in=di),
    }


def param_defs(cfg, tp: int = 1) -> dict:
    return {
        **common.embed_defs(cfg),
        "layers": common.stack_layer_defs(block_defs(cfg, tp), cfg.n_layers),
    }


class SSMBlock(nn.Module):
    """One Mamba2 layer's parameters."""

    def __init__(self, cfg):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        self.ln = nn.Parameter(torch.empty(d))
        self.w_in = nn.Linear(d, 2 * di + 2 * G * N + H, bias=False)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, di + 2 * G * N))
        self.A_log = nn.Parameter(torch.empty(H))
        self.D = nn.Parameter(torch.empty(H))
        self.dt_bias = nn.Parameter(torch.empty(H))
        self.out_norm = nn.Parameter(torch.empty(di))
        self.w_out = nn.Linear(di, d, bias=False)


def _split_proj(proj: torch.Tensor, cfg):
    di = cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state
    return proj.split([di, di, GN, GN, cfg.ssm_heads], dim=-1)


def ssm_block(p: SSMBlock, h: torch.Tensor, cfg, conv_cache=None,
              state=None, ctx: Ctx = NOCTX):
    """The block on ``h`` (B, S, d): returns ``(out, (new conv window, new
    state))``.  Without a ``state`` the whole sequence is scanned (padded
    to a multiple of ``c = min(ssm_chunk, S)`` with ``dt = 0`` steps, which
    leave the state as it is); with one, ``S`` is 1 and one recurrence
    step runs from it.

    Under a mesh the projection is laid out over the tensor axis (the
    reference's constraint) and the part between the two projections
    (:func:`_ssm_core`) runs as a local region on each rank's sequences,
    with the tensor axis whole: the z | x | B | C | dt split of one
    projection does not follow its shards."""
    proj = p.w_in(rms_norm(h, p.ln))
    proj = ctx.constrain(proj, "batch", "seq", "tensor")
    weights = (p.conv_w, p.A_log, p.D, p.dt_bias, p.out_norm)
    if ctx.mesh is None:
        y, caches = _ssm_core(proj, weights, cfg, conv_cache, state)
    else:
        y, caches = _ssm_core_sharded(proj, weights, cfg, conv_cache, state,
                                      ctx)
    return ctx.constrain(p.w_out(y), "batch", "seq", None), caches


def _ssm_core(proj, weights, cfg, conv_cache, state):
    """From the input projection to the gated, normalised output (before
    ``w_out``): ``(y (B, S, d_inner), (new conv window, new state))``."""
    conv_w, A_log, D, dt_bias, out_norm = weights
    Bsz, S, _ = proj.shape
    di = cfg.d_inner
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, x, Bm, Cm, dtr = _split_proj(proj, cfg)
    conv_out, new_conv = causal_conv1d(torch.cat([x, Bm, Cm], dim=-1),
                                       conv_w, conv_cache)
    x, Bm, Cm = conv_out.split([di, G * N, G * N], dim=-1)
    f32 = torch.float32
    dt = F.softplus(dtr.to(f32) + dt_bias.to(f32))
    A = -torch.exp(A_log.to(f32))
    D = D.to(f32)
    xh = x.reshape(Bsz, S, H, P)
    Bh = Bm.reshape(Bsz, S, G, N)
    Ch = Cm.reshape(Bsz, S, G, N)
    if state is None:
        c = min(cfg.ssm_chunk, S)
        pad = (-S) % c
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
            Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
        y, new_state = ssd_chunked(xh, dt, A, Bh, Ch, D, chunk=c)
        y = y[:, :S]
    else:
        y, new_state = ssd_step(xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0], D,
                                state)
        y = y[:, None]
    y = y.reshape(Bsz, S, di)
    y = rms_norm(y * F.silu(z.to(f32)).to(y.dtype), out_norm)
    return y, (new_conv, new_state)


def _ssm_core_sharded(proj, weights, cfg, conv_cache, state, ctx: Ctx):
    """:func:`_ssm_core` as a local region: activations and caches split
    over the batch's mesh axes only, the block's small weights whole."""
    mesh = ctx.mesh

    def batch_only(t):
        return ctx.constrain(t, "batch", *(None,) * (t.ndim - 1))

    proj = batch_only(proj)
    pl = proj.placements
    vary = {i for i, q in enumerate(pl) if isinstance(q, Shard)}
    rep = [Replicate()] * mesh.ndim
    ws = tuple(to_local(w.redistribute(mesh, rep), vary) for w in weights)
    cc = None if conv_cache is None else to_local(batch_only(conv_cache))
    st = None if state is None else to_local(batch_only(state))
    y, (nc, ns) = _ssm_core(to_local(proj), ws, cfg, cc, st)
    Bsz = proj.shape[0]

    def out(t):
        return from_local(t.contiguous(), mesh, pl,
                          (Bsz,) + tuple(t.shape[1:]))
    return out(y), (out(nc), out(ns))


def _ssm_fn(cfg, want_cache: bool, ctx: Ctx = NOCTX):
    """The layer function of :func:`common.scan_blocks`."""
    def fn(carry, p: SSMBlock):
        h, extra = carry
        out, cache = ssm_block(p, h, cfg, ctx=ctx)
        return (ctx.constrain(h + out, "batch", "seq", None), extra), \
            (cache if want_cache else None)
    return fn


def decode_layers(layers, h, cache: dict, cfg, lo: int = 0,
                  ctx: Ctx = NOCTX):
    """One token through ``layers`` (the stack's layers ``lo``, ``lo + 1``,
    ...), each from its conv window and state in ``cache``, which are
    overwritten in place with the new ones (cast to the cache's dtypes, as
    the reference keeps them)."""
    conv, state = cache["conv"], cache["state"]
    for i, p in enumerate(layers, start=lo):
        out, (c, st) = ssm_block(p, h, cfg, conv_cache=conv[i],
                                 state=state[i], ctx=ctx)
        h = h + out
        conv[i].copy_(c)
        state[i].copy_(st)
    return h


class Mamba2Model(nn.Module):
    """Embedding, ``cfg.n_layers`` SSM blocks, final norm and output head."""

    def __init__(self, cfg, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.vocab_padded(), cfg.d_model
        self.tok = nn.Embedding(V, d)
        self.out = nn.Linear(d, V, bias=False)
        self.final_norm = nn.Parameter(torch.empty(d))
        self.layers = nn.ModuleList(SSMBlock(cfg)
                                    for _ in range(cfg.n_layers))

    def forward(self, batch: dict, ctx: Ctx = NOCTX,
                return_hidden: bool = False, return_cache: bool = False):
        cfg = self.cfg
        h = common.embed_tokens(self, batch["tokens"], ctx)
        h = common.maybe_prepend_embeds(h, batch, ctx)
        h, _, ys = common.scan_blocks(
            _ssm_fn(cfg, return_cache, ctx), h, self.layers,
            remat=(cfg.remat == "block") and not return_cache)
        if return_hidden:
            return h
        logits = common.unembed(self, h, ctx)
        if not return_cache:
            return logits
        return logits, {"conv": ys[0], "state": ys[1],
                        "pos": torch.full((), h.shape[1] - 1,
                                          dtype=torch.int32,
                                          device=h.device)}

    def decode(self, cache: dict, tokens: torch.Tensor, ctx: Ctx = NOCTX):
        h = common.embed_tokens(self, tokens, ctx)
        h = decode_layers(self.layers, h, cache, self.cfg, ctx=ctx)
        return common.unembed(self, h, ctx), {**cache,
                                              "pos": cache["pos"] + 1}


def cache_defs(cfg, B: int, S: int) -> dict:
    """Shapes of a decode cache (the reference's): O(1) in ``S``, a conv
    window and an SSM state per layer.  :func:`common.init_cache` makes
    it, with the state in f32 as a prefill leaves it."""
    L = cfg.n_layers
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    return {
        "conv": ParamDef((L, B, cfg.ssm_conv - 1, cfg.d_inner + 2 * G * N),
                         ("layers", "batch", None, "tensor"), init="zeros"),
        "state": ParamDef((L, B, H, P, N),
                          ("layers", "batch", "tensor", None, None),
                          init="zeros"),
        "pos": ParamDef((), (), init="zeros"),
    }


def build(cfg, params, *, dtype=None, device=None,
          tp: int = 1) -> Mamba2Model:
    """A :class:`Mamba2Model` holding ``params`` (a tree in the reference's
    layout, see :func:`param_defs`), on ``device`` (default: the card),
    cast to ``dtype`` if given.  Built for inference: no gradients."""
    return common.build(Mamba2Model, cfg, params, dtype=dtype, device=device,
                        tp=tp)


def forward(params: Mamba2Model, batch: dict, cfg, ctx: Ctx = NOCTX,
            return_cache: bool = False, return_hidden: bool = False):
    """The reference's ``forward(params, batch, cfg)``: logits (B, S, V), or
    the hidden states (B, S, d) before the final norm, or with
    ``return_cache`` the logits and the prefill cache (``conv``, ``state``,
    ``pos``).  Inference mode unless the parameters require gradients and
    autograd is enabled (the trainer's network)."""
    return common.forward(params, batch, cfg, ctx,
                          return_hidden=return_hidden,
                          return_cache=return_cache)


def decode_step(params: Mamba2Model, cache: dict, tokens: torch.Tensor, cfg,
                ctx: Ctx = NOCTX):
    """One decode step: ``tokens`` (B, 1) at position ``cache["pos"] + 1``
    -> ``(logits (B, 1, V), cache)``; the cache's ``conv`` and ``state`` are
    updated in place and returned with the new ``pos``."""
    return common.decode_step(params, cache, tokens, cfg, ctx)
