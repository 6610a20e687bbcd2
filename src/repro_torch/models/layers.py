"""Dense building blocks of the transformer, in plain torch ops.

Each function computes what its namesake in the reference
(``src/repro/models/layers.py``) computes, with the same dtype handling
(norms, rope and softmax in f32; products in the working dtype), so the
forward pass can be held to the reference's.  Attention is written out with
``einsum`` and ``softmax`` rather than a fused library operator, which
would round otherwise.  Two schedules:

* :func:`attn_full`    — materialised scores (sequences up to 2048);
* :func:`attn_chunked` — blockwise online softmax over q and kv blocks, so a
  long sequence never materialises an ``S x S`` score tensor;
* :func:`attn_decode`  — one new token against the OLD decode cache plus an
  explicit self-token term (the cache is written once per step, after the
  layers, by :func:`update_cache`).

The MoE layer is the reference's token-choice top-k router
(:func:`moe_router`), capacity dispatch (:func:`moe_dispatch`,
:func:`moe_expert_compute`) and routed plus shared experts
(:func:`moe_block`), with every expert on the one card.

The reference's sharding context (``Ctx``) and its ``shard_map`` branches
(the sharded cache write, expert parallelism) have no counterpart on one
card: the port runs the reference's no-mesh branch.

Mamba2's pieces close the file: the depthwise causal convolution
(:func:`causal_conv1d`, with its streaming cache), the chunked SSD scan
(:func:`ssd_chunked`) and its one-step recurrence (:func:`ssd_step`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin tables (..., dim//2), f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., dim) with the halves convention (x1 | x2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    while cos.ndim < x1.ndim:
        cos, sin = cos[..., None, :], sin[..., None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x W_g) * (x W_u) W_d``, weights in ``nn.Linear``'s
    ``(out, in)`` layout."""
    g = F.linear(x, wg)
    u = F.linear(x, wu)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return F.linear(h, wd)


def _expand_kv(k: torch.Tensor, n_q_heads: int,
               group_size: Optional[int] = None) -> torch.Tensor:
    """Map each query head to its GQA kv head: ``kv = min(h // g, Hkv-1)``."""
    Hkv = k.shape[2]
    if n_q_heads == Hkv:
        return k
    g = group_size or max(n_q_heads // Hkv, 1)
    idx = torch.clamp_max(torch.arange(n_q_heads, device=k.device) // g,
                          Hkv - 1)
    return k[:, :, idx, :]


def attn_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              group_size: Optional[int] = None) -> torch.Tensor:
    """(B,Sq,H,dh) x (B,Sk,Hkv,dh) -> (B,Sq,H,dh), materialised scores."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H, group_size)
    v = _expand_kv(v, H, group_size)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(dh)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where((ki <= qi)[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_chunk: int = 512, kv_chunk: int = 512, causal: bool = True,
                 group_size: Optional[int] = None) -> torch.Tensor:
    """Blockwise online-softmax attention (no ``S x S`` tensor).

    A q block visits only the kv blocks up to its own last position when
    ``causal`` (the reference's triangular bucketing, at the granularity of
    one q block)."""
    B, S, H, dh = q.shape
    dv = v.shape[-1]
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    if S % qc or S % kc:
        raise ValueError(f"sequence {S} is not a multiple of the chunks "
                         f"({qc}, {kc})")
    nk = S // kc
    scale = 1.0 / math.sqrt(dh)
    kr = _expand_kv(k, H, group_size).reshape(B, nk, kc, H, dh)
    vr = _expand_kv(v, H, group_size).reshape(B, nk, kc, H, dv)
    outs = []
    for qi in range(S // qc):
        qb = q[:, qi * qc:(qi + 1) * qc]
        nk_eff = min(nk, ((qi + 1) * qc + kc - 1) // kc) if causal else nk
        m = torch.full((B, H, qc), -1e30, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk_eff):
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kr[:, j]).to(
                torch.float32) * scale
            if causal:
                qpos = qi * qc + torch.arange(qc, device=q.device)[:, None]
                kpos = j * kc + torch.arange(kc, device=q.device)[None, :]
                s = torch.where((kpos <= qpos)[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vr.dtype), vr[:, j]).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(lsum[..., None], 1e-30)
        outs.append(out.transpose(1, 2))  # (B, qc, H, dv)
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def update_cache(cache: torch.Tensor, new: torch.Tensor, pos,
                 seq_axis: int = 1) -> torch.Tensor:
    """Write one decode step into ``cache`` at position ``pos`` along
    ``seq_axis``, in place, and return it (the reference's
    ``dynamic_update_slice`` on a donated, aliased buffer).  Called once per
    step on the layer-stacked cache.  ``new`` has length 1 on that axis;
    ``pos`` is an int or a 0-d tensor on the cache's device (no wait for the
    card) and must lie inside the cache."""
    idx = torch.as_tensor(pos, device=cache.device).reshape(1).to(
        torch.int64)
    return cache.index_copy_(seq_axis, idx, new.to(cache.dtype))


def softmax_with_self(s: torch.Tensor, s_self: torch.Tensor):
    """The softmax weights of the cached scores ``s`` and the self-token's
    ``s_self`` (last axis), normalised together without a concatenation."""
    m = torch.maximum(s.amax(dim=-1, keepdim=True),
                      s_self.amax(dim=-1, keepdim=True))
    p_c = torch.exp(s - m)
    p_s = torch.exp(s_self - m)
    denom = p_c.sum(dim=-1, keepdim=True) + p_s.sum(dim=-1, keepdim=True)
    return p_c / denom, p_s / denom


def attn_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos, k_new: Optional[torch.Tensor] = None,
                v_new: Optional[torch.Tensor] = None,
                group_size: Optional[int] = None) -> torch.Tensor:
    """One-step attention: q ``(B,1,H,dh)`` against the OLD cache
    ``(B,S,Hkv,dh)`` plus the new token's own k/v ``(B,1,Hkv,dh)`` as an
    explicit extra term; cache entries at positions ``>= pos`` (the new
    token's position) are masked.

    With ``group_size`` and ``H == Hkv * group_size`` the grouped form
    contracts each query group against its kv head and never expands the
    cache; otherwise the kv heads are expanded to the query heads.  Scores
    and softmax in f32, products in the operands' dtype."""
    B, _, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(dh)
    if group_size and H == Hkv * group_size:
        qg = q.reshape(B, 1, Hkv, group_size, dh)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).to(
            torch.float32) * scale
        mask = torch.arange(S, device=q.device) < pos
        s = torch.where(mask, s, -1e30)
        if k_new is not None:
            s_self = torch.einsum("bqkgd,bskd->bkgqs", qg, k_new).to(
                torch.float32) * scale
            w_c, w_s = softmax_with_self(s, s_self)
            out = torch.einsum("bkgqs,bskd->bqkgd", w_c.to(v_cache.dtype),
                               v_cache)
            out = out + torch.einsum("bkgqs,bskd->bqkgd",
                                     w_s.to(v_new.dtype), v_new)
            return out.reshape(B, 1, H, dh)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v_cache.dtype), v_cache)
        return out.reshape(B, 1, H, dh)
    k = _expand_kv(k_cache, H, group_size)
    v = _expand_kv(v_cache, H, group_size)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    mask = torch.arange(S, device=q.device) < pos
    scores = torch.where(mask, scores, -1e30)
    if k_new is not None:
        kn = _expand_kv(k_new, H, group_size)
        vn = _expand_kv(v_new, H, group_size)
        s_self = torch.einsum("bqhd,bkhd->bhqk", q, kn).to(
            torch.float32) * scale
        w_c, w_s = softmax_with_self(scores, s_self)
        out = torch.einsum("bhqk,bkhd->bqhd", w_c.to(v.dtype), v)
        return out + torch.einsum("bhqk,bkhd->bqhd", w_s.to(vn.dtype), vn)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


# ---------------------------------------------------------------------------
# MoE: token-choice top-k, capacity dispatch, routed + shared experts
# ---------------------------------------------------------------------------

def moe_router(x: torch.Tensor, wr: torch.Tensor, top_k: int):
    """x ``(T, d)``, router weight ``wr`` ``(E, d)`` (``nn.Linear``'s
    layout of the reference's ``(d, E)``) -> ``(gates (T, k), idx (T, k),
    aux)``: softmax over the experts in f32, the top k, gates renormalised
    to sum 1, and the Switch load-balancing loss ``E * sum(me * ce)`` (mean
    router probability times the share of assignments, per expert)."""
    logits = F.linear(x, wr).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    E = wr.shape[0]
    me = probs.mean(dim=0)
    # assignments per expert: a scatter-add of ones, which (unlike
    # ``bincount``) also runs on ``meta`` tensors
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device
                         ).scatter_add_(0, flat, torch.ones_like(flat))
    ce = counts.to(torch.float32) / idx.numel()
    aux = E * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux


def moe_dispatch(gates: torch.Tensor, idx: torch.Tensor, n_experts: int,
                 capacity: int):
    """The capacity dispatch buffers ``(buf_t, buf_g)``, each
    ``(n_experts, capacity)``: slot ``(e, c)`` holds token index + 1 (0:
    empty) and its gate.

    An assignment's rank within its expert is its place in the cumulative
    count over the ``T * k`` flattened assignments, token-major; ranks at or
    past ``capacity`` are dropped, exactly the reference's tokens."""
    T, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    onehot = F.one_hot(flat_e, n_experts)
    rank = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    keep = rank < capacity
    slot_r = torch.where(keep, rank, capacity)  # dropped: the dump column
    buf_t = torch.zeros((n_experts, capacity + 1), dtype=torch.int64,
                        device=dev)
    buf_t[flat_e, slot_r] = torch.where(keep, flat_t + 1, 0)
    buf_g = torch.zeros((n_experts, capacity + 1), dtype=flat_g.dtype,
                        device=dev)
    buf_g[flat_e, slot_r] = torch.where(keep, flat_g, 0.0)
    return buf_t[:, :capacity], buf_g[:, :capacity]


def moe_expert_compute(x_flat: torch.Tensor, gates: torch.Tensor,
                       idx: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor, *,
                       capacity: int) -> torch.Tensor:
    """Capacity dispatch over the experts ``w_*`` (``(E, d, f)``,
    ``(E, d, f)``, ``(E, f, d)``, the reference's layout): each expert runs
    SwiGLU on its ``capacity`` slots (empty slots are zero rows), outputs
    are scaled by their gates and summed back per token.  x_flat ``(T, d)``,
    idx ``(T, k)`` expert ids; returns ``(T, d)``.  Every expert's weights
    are read whatever the batch (the dispatch is dense over experts)."""
    T, d = x_flat.shape
    buf_t, buf_g = moe_dispatch(gates, idx, w_gate.shape[0], capacity)
    occupied = buf_t > 0
    xg = x_flat[torch.clamp_min(buf_t - 1, 0)]           # (E, C, d)
    xg = xg * occupied[..., None].to(xg.dtype)
    g = torch.bmm(xg, w_gate)
    u = torch.bmm(xg, w_up)
    h = F.silu(g.to(torch.float32)).to(xg.dtype) * u
    y = torch.bmm(h, w_down)
    y = y * buf_g[..., None].to(y.dtype)
    out = torch.zeros((T + 1, d), dtype=y.dtype, device=y.device)
    out.index_add_(0, buf_t.reshape(-1), y.reshape(-1, d))
    return out[1:]


def moe_block(p, x: torch.Tensor, cfg):
    """The MoE layer on x ``(B, S, d)``: routed experts over all ``B * S``
    tokens with ``capacity = max(8, int(T * k * capacity_factor) // E)``,
    plus the shared experts as one dense SwiGLU.  ``p`` holds ``router``
    (``nn.Linear``), ``w_gate``/``w_up``/``w_down`` (expert stacks) and, with
    ``cfg.n_shared_experts``, ``shared`` (``wg``/``wu``/``wd``).  Returns
    ``(out, aux)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    gates, idx, aux = moe_router(xf, p.router.weight, k)
    cap = max(8, int(T * k * cfg.capacity_factor) // E)
    out = moe_expert_compute(xf, gates, idx, p.w_gate, p.w_up, p.w_down,
                             capacity=cap)
    out = out.reshape(x.shape)
    if cfg.n_shared_experts:
        sh = p.shared
        out = out + gated_mlp(x, sh.wg.weight, sh.wu.weight, sh.wd.weight)
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD): chunked scan, single-step recurrence, causal convolution
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                chunk: int):
    """Chunked state-space-duality scan (Mamba2).

    x ``(B,S,H,P)``, dt ``(B,S,H)`` (post-softplus, f32), A ``(H,)``
    (negative), Bm/Cm ``(B,S,G,N)``, D ``(H,)``; ``S`` a multiple of
    ``min(chunk, S)``.  Returns y ``(B,S,H,P)`` in x's dtype and the final
    state ``(B,H,P,N)`` in f32.  Head ``h`` reads group ``h // (H // G)``
    (the reference's ``repeat``), contracted here per group without
    repeating B and C.

    The within-chunk decay ``exp(cum_t - cum_s)`` is taken of ``-inf``
    above the diagonal (``s > t``), where the reference exponentiates the
    positive difference and discards it afterwards: at a chunk of 128 that
    difference passes 88.7 and overflows f32, and the discarded branch's
    zero cotangent times ``inf`` makes the reference's gradient NaN.  The
    forward values are the same."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {c}")
    nc = S // c
    f32 = torch.float32
    xs = x.reshape(Bsz, nc, c, H, Pd)
    dts = dt.reshape(Bsz, nc, c, H)
    Bs = Bm.reshape(Bsz, nc, c, G, N)
    Cs = Cm.reshape(Bsz, nc, c, G, N)

    dA = dts * A                                     # (B,k,c,H) negative
    cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum
    seg_end = cum[:, :, -1, :]                       # total chunk decay

    # intra-chunk (quadratic in c): y[t] = sum_{s<=t} C_t.B_s decay x_s dt_s
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,k,c,s,H)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bkcgn,bksgn->bkgcs", Cs, Bs).to(f32)
    att = cb[:, :, :, None] * decay.permute(0, 1, 4, 2, 3).reshape(
        Bsz, nc, G, rep, c, c)                        # (B,k,G,r,c,s)
    xdt = (xs * dts[..., None]).to(f32).reshape(Bsz, nc, c, G, rep, Pd)
    y_intra = torch.einsum("bkgrcs,bksgrp->bkcgrp", att, xdt)

    # contribution of each chunk to its own end state
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cum)   # (B,k,c,H)
    state_in = torch.einsum(
        "bkcgn,bkcgrp->bkgrpn", Bs.to(f32),
        xdt * decay_to_end.reshape(Bsz, nc, c, G, rep)[..., None])

    # inter-chunk recurrence over chunks (the reference's lax.scan)
    h = torch.zeros((Bsz, G, rep, Pd, N), dtype=f32, device=x.device)
    prev = []
    for k in range(nc):
        prev.append(h)
        h = h * torch.exp(seg_end[:, k]).reshape(Bsz, G, rep, 1, 1) \
            + state_in[:, k]
    h_prev = torch.stack(prev, dim=1)                 # (B,k,G,r,P,N)

    # inter-chunk output: C_t . (decay from the chunk's start) . h_prev
    y_inter = torch.einsum("bkcgn,bkgrpn->bkcgrp", Cs.to(f32), h_prev) \
        * torch.exp(cum).reshape(Bsz, nc, c, G, rep)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    y = y + x.to(f32) * D[None, None, :, None]
    return y.to(x.dtype), h.reshape(Bsz, H, Pd, N)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             h: torch.Tensor):
    """One decode step of the recurrence: x ``(B,H,P)``, dt ``(B,H)`` f32,
    Bm/Cm ``(B,G,N)``, state h ``(B,H,P,N)``.  Returns y ``(B,H,P)`` in x's
    dtype and the new state (f32 for an f32 state); y contracts C with the
    new state cast to C's dtype, as the reference does."""
    rep = x.shape[1] // Bm.shape[1]
    Bs = Bm.repeat_interleave(rep, dim=1)             # (B,H,N)
    Cs = Cm.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A[None, :])[..., None, None]  # (B,H,1,1)
    xdt = x * dt[..., None]
    upd = torch.einsum("bhn,bhp->bhpn", Bs.to(xdt.dtype), xdt)
    h_new = h * dA + upd
    y = torch.einsum("bhn,bhpn->bhp", Cs, h_new.to(Cs.dtype))
    y = y + x * D[None, :, None]
    return y.to(x.dtype), h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None):
    """Depthwise causal convolution: x ``(B,S,C)``, w ``(K,C)``; SiLU in
    f32, cast back to x's dtype.  With a cache ``(B,K-1,C)`` (the last
    ``K-1`` inputs) it is the streaming update.  Returns ``(y, new
    cache)``."""
    K = w.shape[0]
    if cache is None:
        pad = F.pad(x, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([cache, x], dim=1)
    S = x.shape[1]
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i]
    new_cache = pad[:, pad.shape[1] - (K - 1):, :]
    return F.silu(out.to(torch.float32)).to(x.dtype), new_cache
