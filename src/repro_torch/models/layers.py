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

The mesh context :class:`Ctx` is the reference's: a
``torch.distributed`` ``DeviceMesh`` and the logical-axis rules
(``launch/sharding.py``).  Under a mesh the parameters and activations are
``DTensor``s; ``ctx.constrain`` redistributes an activation to the layout
of its logical axes at the reference's constraint points (the Megatron
schedule of :func:`gated_mlp`, the cache-length-sharded scores of
:func:`attn_decode`), and :func:`Ctx.scope` lets plain tensors stand for
replicated ones.  The reference's two ``shard_map`` branches are explicit
local regions (``to_local``, the reference's local function,
``from_local`` and a redistribution, whose collectives are
``c10d_functional`` ops): :func:`update_cache`, where only the shard
owning ``pos`` writes, and :func:`moe_block`'s expert parallelism, where
each shard dispatches its own tokens to its own experts and one
all-reduce over ``model`` sums the partial outputs.  So is attention
(:func:`_local_heads`: each rank's heads), where ``DTensor`` would
reshard inside the score products.  With ``Ctx(None)`` (:data:`NOCTX`)
every constraint is the identity and every function runs the reference's
no-mesh branch.

Mamba2's pieces close the file: the depthwise causal convolution
(:func:`causal_conv1d`, with its streaming cache), the chunked SSD scan
(:func:`ssd_chunked`) and its one-step recurrence (:func:`ssd_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch import sharding as shd


@dataclasses.dataclass(frozen=True)
class Ctx:
    """A ``DeviceMesh`` (or None) and the logical-axis rules."""

    mesh: Optional[object]
    rules: Optional[Dict] = None

    def constrain(self, x, *logical):
        """``x`` laid out by its logical axes (``sharding.constrain``); the
        identity, returning ``x`` itself, without a mesh."""
        if self.mesh is None:
            return x
        return shd.constrain(x, self.mesh, self.rules, *logical)

    def axis_size(self, logical: str) -> int:
        """The number of shards of the logical axis ``logical``: the
        product of the sizes of its mesh axes present in the mesh (1
        without a mesh)."""
        if self.mesh is None:
            return 1
        ax = self.rules.get(logical)
        if ax is None:
            return 1
        shape = shd.named(self.mesh).shape
        n = 1
        for a in (ax,) if isinstance(ax, str) else ax:
            if a in shape:
                n *= shape[a]
        return n

    def scope(self):
        """The context a partitioned program runs in: plain tensors mixed
        with ``DTensor``s count as replicated (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return implicit_replication()


NOCTX = Ctx(None)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``t`` (which every rank holds whole) as a replicated
    ``DTensor`` on ``ref``'s mesh when ``ref`` is a ``DTensor``: an index
    or mask an op saves for its backward pass, which does not run under
    ``Ctx.scope``'s implicit replication."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, ref.device_mesh,
                                  [Replicate()] * ref.device_mesh.ndim,
                                  run_check=False)
    return t


def masked(mask: torch.Tensor, s: torch.Tensor, fill: float = -1e30):
    """``torch.where(mask, s, fill)`` (a plain mask beside a ``DTensor``
    replicated: :func:`replicated_like`)."""
    return torch.where(replicated_like(mask, s), s, fill)


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
              wd: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
    """SwiGLU: ``silu(x W_g) * (x W_u) W_d``, weights in ``nn.Linear``'s
    ``(out, in)`` layout.  With ``ctx`` the hidden axis is pinned to the
    tensor axis (column-parallel up, row-parallel down, one all-reduce)."""
    g = F.linear(x, wg)
    u = F.linear(x, wu)
    if ctx is not None:
        hidden = ("batch",) + (None,) * (g.ndim - 2) + ("tensor",)
        g = ctx.constrain(g, *hidden)
        u = ctx.constrain(u, *hidden)
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
    return k[:, :, replicated_like(idx, k), :]


def attn_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              group_size: Optional[int] = None) -> torch.Tensor:
    """(B,Sq,H,dh) x (B,Sk,Hkv,dh) -> (B,Sq,H,dh), materialised scores."""
    if isinstance(q, DTensor):
        return _local_heads(attn_full, q, k, v, group_size, causal=causal,
                            q_offset=q_offset)
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H, group_size)
    v = _expand_kv(v, H, group_size)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(dh)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        scores = masked((ki <= qi)[None, None], scores)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_chunk: int = 512, kv_chunk: int = 512, causal: bool = True,
                 group_size: Optional[int] = None,
                 ctx: Optional[Ctx] = None) -> torch.Tensor:
    """Blockwise online-softmax attention (no ``S x S`` tensor).

    A q block visits only the kv blocks up to its own last position when
    ``causal`` (the reference's triangular bucketing, at the granularity of
    one q block).  Under a mesh the block loops run on each rank's heads
    (:func:`_local_heads`): the reference pins the expanded kv blocks and
    the queries head-sharded before its block scans; here no block is
    ever resharded.  (``ctx`` is the reference's argument; the layout is
    the queries'.)"""
    if isinstance(q, DTensor):
        return _local_heads(attn_chunked, q, k, v, group_size,
                            q_chunk=q_chunk, kv_chunk=kv_chunk, causal=causal)
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
                s = masked((kpos <= qpos)[None, None], s)
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

def _local_heads(fn, q: DTensor, k, v, group_size, **kw) -> DTensor:
    """``fn`` (:func:`attn_full`, :func:`attn_chunked`) as a local region
    on each rank's heads (batch and heads split like the queries: every
    head's attention is its own), the output laid out like the queries.
    Keys and values with as many heads as the queries are split like them;
    fewer (GQA) are taken whole and expanded to this rank's query heads
    locally."""
    mesh, pl = q.device_mesh, list(q.placements)
    H = q.shape[2]
    heads = {i for i, p in enumerate(pl) if p == Shard(2)}
    h0, hl = local_offset(q, 2), q.to_local().shape[2]

    def local_kv(t):
        if t.shape[2] == H:
            return t.redistribute(mesh, pl).to_local()
        whole = [Replicate() if i in heads else p for i, p in enumerate(pl)]
        t = to_local(t.redistribute(mesh, whole), heads)
        return _expand_kv(t, H, group_size)[:, :, h0:h0 + hl]
    out = fn(q.to_local(), local_kv(k), local_kv(v), **kw).contiguous()
    return from_local(out, mesh, pl, tuple(q.shape[:3]) + (v.shape[3],))


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos,
                 ctx: Ctx = NOCTX, seq_axis: int = 1) -> torch.Tensor:
    """Write one decode step into ``cache`` at position ``pos`` along
    ``seq_axis``, in place, and return it (the reference's
    ``dynamic_update_slice`` on a donated, aliased buffer).  Called once per
    step on the layer-stacked cache.  ``new`` has length 1 on that axis;
    ``pos`` is an int or a 0-d tensor on the cache's device (no wait for the
    card) and must lie inside the cache.

    Under a mesh the cache is a ``DTensor`` whose length axis may be split
    (over ``model`` at serving): each rank writes into its own shard at
    ``pos - shard * S_local``, clipped into the shard, the new values where
    that offset lies inside it and the shard's own values elsewhere (the
    reference's ``shard_map`` branch ``upd``).  ``new`` is laid out like the
    cache with its length axis whole; no cache is gathered and ``pos`` is
    never read on the host."""
    if ctx.mesh is None:
        idx = torch.as_tensor(pos, device=cache.device).reshape(1).to(
            torch.int64)
        return cache.index_copy_(seq_axis, idx, new.to(cache.dtype))
    mesh = ctx.mesh
    pl = list(cache.placements)
    npl = [Replicate() if isinstance(p, Shard) and p.dim == seq_axis else p
           for p in pl]
    if not isinstance(new, DTensor):
        new = shd.distribute_tensor(new, mesh, npl, src_data_rank=None)
    n_loc = new.redistribute(mesh, npl).to_local()
    c_loc = cache.to_local()
    shard = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == seq_axis:
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    s_loc = c_loc.shape[seq_axis]
    p_loc = pos.to_local() if isinstance(pos, DTensor) else pos
    off = torch.as_tensor(p_loc, device=c_loc.device).to(torch.int64) \
        - shard * s_loc
    inb = (off >= 0) & (off < s_loc)
    off_c = off.clamp(0, s_loc - 1).reshape(1)
    cur = c_loc.index_select(seq_axis, off_c)
    c_loc.index_copy_(seq_axis, off_c,
                      torch.where(inb, n_loc.to(c_loc.dtype), cur))
    return cache


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
                v_new: Optional[torch.Tensor] = None, ctx: Ctx = NOCTX,
                group_size: Optional[int] = None) -> torch.Tensor:
    """One-step attention: q ``(B,1,H,dh)`` against the OLD cache
    ``(B,S,Hkv,dh)`` plus the new token's own k/v ``(B,1,Hkv,dh)`` as an
    explicit extra term; cache entries at positions ``>= pos`` (the new
    token's position) are masked.

    With ``group_size`` and ``H == Hkv * group_size`` the grouped form
    contracts each query group against its kv head and never expands the
    cache; otherwise the kv heads are expanded to the query heads.  Scores
    and softmax in f32, products in the operands' dtype.  Under a mesh the
    scores are pinned to the cache's length sharding (``kv_seq``): the
    softmax's maximum and sum become reductions over cache shards."""
    B, _, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(dh)
    # the query's heads whole: the cache's length may be split over the
    # axis that splits them, and a head split need not split into (kv
    # head, group)
    q = ctx.constrain(q, "batch", None, None, None)
    if group_size and H == Hkv * group_size:
        qg = q.reshape(B, 1, Hkv, group_size, dh)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).to(
            torch.float32) * scale
        s = ctx.constrain(s, "batch", None, None, None, "kv_seq")
        mask = torch.arange(S, device=q.device) < pos
        s = masked(mask, s)
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
    scores = ctx.constrain(scores, "batch", None, None, "kv_seq")
    mask = torch.arange(S, device=q.device) < pos
    scores = masked(mask, scores)
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
                 capacity: int, expert_offset=0):
    """The capacity dispatch buffers ``(buf_t, buf_g)``, each
    ``(n_experts, capacity)``: slot ``(e, c)`` holds token index + 1 (0:
    empty) and its gate.

    An assignment's rank within its expert is its place in the cumulative
    count over the ``T * k`` flattened assignments, token-major; ranks at or
    past ``capacity`` are dropped, exactly the reference's tokens.  The
    experts are ids ``expert_offset .. expert_offset + n_experts - 1`` (an
    expert-parallel shard's own); assignments to other experts are not
    this shard's and take no slot."""
    T, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1) - expert_offset
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    mine = (flat_e >= 0) & (flat_e < n_experts)
    e_safe = torch.where(mine, flat_e, 0)
    onehot = F.one_hot(e_safe, n_experts) * mine[:, None]
    rank = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    keep = mine & (rank < capacity)
    slot_r = torch.where(keep, rank, capacity)  # dropped: the dump column
    buf_t = torch.zeros((n_experts, capacity + 1), dtype=torch.int64,
                        device=dev)
    buf_t[e_safe, slot_r] = torch.where(keep, flat_t + 1, 0)
    buf_g = torch.zeros((n_experts, capacity + 1), dtype=flat_g.dtype,
                        device=dev)
    buf_g[e_safe, slot_r] = torch.where(keep, flat_g, 0.0)
    return buf_t[:, :capacity], buf_g[:, :capacity]


def moe_expert_compute(x_flat: torch.Tensor, gates: torch.Tensor,
                       idx: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor, *,
                       capacity: int, expert_offset=0) -> torch.Tensor:
    """Capacity dispatch over the experts ``w_*`` (``(E, d, f)``,
    ``(E, d, f)``, ``(E, f, d)``, the reference's layout): each expert runs
    SwiGLU on its ``capacity`` slots (empty slots are zero rows), outputs
    are scaled by their gates and summed back per token.  x_flat ``(T, d)``,
    idx ``(T, k)`` expert ids; returns ``(T, d)``.  Every expert's weights
    are read whatever the batch (the dispatch is dense over experts).  The
    experts ``w_*`` are ids ``expert_offset ..`` (an expert-parallel
    shard's; the output then sums over them only); a shard without
    experts returns zeros."""
    T, d = x_flat.shape
    if w_gate.shape[0] == 0:
        return x_flat.new_zeros((T, d))
    buf_t, buf_g = moe_dispatch(gates, idx, w_gate.shape[0], capacity,
                                expert_offset)
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


def moe_block(p, x: torch.Tensor, cfg, ctx: Ctx = NOCTX):
    """The MoE layer on x ``(B, S, d)``: routed experts over all ``B * S``
    tokens with ``capacity = max(8, int(T * k * capacity_factor) // E)``,
    plus the shared experts as one dense SwiGLU.  ``p`` holds ``router``
    (``nn.Linear``), ``w_gate``/``w_up``/``w_down`` (expert stacks) and, with
    ``cfg.n_shared_experts``, ``shared`` (``wg``/``wu``/``wd``).  Returns
    ``(out, aux)``.

    Under a mesh the routed experts run expert-parallel
    (:func:`_moe_sharded`): each shard routes its own tokens, so ``T``, the
    capacity and the drops are per data shard, as in the reference's
    ``shard_map`` branch."""
    if ctx.mesh is not None:
        out, aux = _moe_sharded(p, x, cfg, ctx)
    else:
        B, S, d = x.shape
        T = B * S
        xf = x.reshape(T, d)
        gates, idx, aux = moe_router(xf, p.router.weight, cfg.top_k)
        out = moe_expert_compute(xf, gates, idx, p.w_gate, p.w_up, p.w_down,
                                 capacity=moe_capacity(T, cfg))
        out = out.reshape(x.shape)
    if cfg.n_shared_experts:
        sh = p.shared
        out = out + gated_mlp(x, sh.wg.weight, sh.wu.weight, sh.wd.weight)
    return out, aux


def moe_capacity(T: int, cfg) -> int:
    """Slots per expert for ``T`` routed tokens."""
    return max(8, int(T * cfg.top_k * cfg.capacity_factor) // cfg.n_experts)


def _moe_sharded(p, x, cfg, ctx: Ctx):
    """The reference's ``shard_map`` branch of ``moe_block`` as a local
    region.  Tokens are split over the batch axes and whole over ``model``,
    the router is whole, the experts are split over ``model``; each rank
    routes its tokens to its experts (ids from its shard's offset) and its
    partial output is summed over ``model`` by one all-reduce.  The aux
    loss is averaged over ``model`` and, as the reference returns it from
    one replicated output, is data shard 0's, while its gradient is that
    of the mean over the data shards (the reference's transpose)."""
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    x_pl = shd.sharding(mesh, ctx.rules, "batch", None, None,
                        shape=tuple(x.shape))
    # ranks differ along the batch's mesh axes (their tokens) and along
    # model (their experts)
    batch_dims = {i for i, pl in enumerate(x_pl) if isinstance(pl, Shard)}
    model_dims = {names.index("model")} if "model" in names else set()
    x_loc = to_local(ctx.constrain(x, "batch", None, None), model_dims)
    rep = [Replicate()] * len(names)
    wr = to_local(p.router.weight.redistribute(mesh, rep),
                  batch_dims | model_dims)
    e_pl = [Shard(0) if n == "model" else Replicate() for n in names]
    ws = [w.redistribute(mesh, e_pl) for w in (p.w_gate, p.w_up, p.w_down)]
    shift = local_offset(ws[0], 0)
    B, S, d = x_loc.shape
    T = B * S
    xf = x_loc.reshape(T, d)
    gates, idx, aux = moe_router(xf, wr, cfg.top_k)
    out = moe_expert_compute(xf, gates, idx,
                             *(to_local(w, batch_dims) for w in ws),
                             capacity=moe_capacity(T, cfg),
                             expert_offset=shift)
    # each rank's partial output enters the sum once: its gradient is the
    # whole one (grad_placements)
    part = [Partial() if n == "model" else pl for n, pl in zip(names, x_pl)]
    out = from_local(out.reshape(x_loc.shape), mesh, part, x.shape,
                     grad_placements=x_pl).redistribute(mesh, x_pl)
    # one aux per data shard: (n_shards,) split like the batch, summed over
    # model; data shard 0's, divided by the model axis (pmean)
    n_shards = 1
    for n, pl in zip(names, x_pl):
        n_shards *= mesh.size(names.index(n)) if isinstance(pl, Shard) else 1
    a_pl = [Partial() if n == "model" else
            Shard(0) if isinstance(pl, Shard) else Replicate()
            for n, pl in zip(names, x_pl)]
    auxes = from_local(aux.reshape(1), mesh, a_pl, (n_shards,),
                       grad_placements=[Replicate() if isinstance(p, Partial)
                                        else p for p in a_pl])
    tp = mesh.size(names.index("model")) if "model" in names else 1
    auxes = auxes.redistribute(mesh, [Replicate()] * len(names)) / tp
    # the reference's value is data shard 0's, its gradient that of the
    # mean over data shards (each shard's cotangent is the replicated
    # output's): that value, that gradient
    mean = auxes.mean()
    return out, auxes[0].detach() + (mean - mean.detach())


def to_local(t: DTensor, vary=()) -> torch.Tensor:
    """This rank's shard of ``t`` for a local region whose ranks compute
    different things along the mesh axes ``vary`` (indices): there a
    replicated input's gradient is partial, one share per rank, and is
    summed (the transpose of a ``shard_map`` input that is replicated
    over an axis the region maps over)."""
    return t.to_local(grad_placements=[
        Partial() if i in vary and isinstance(p, Replicate) else p
        for i, p in enumerate(t.placements)])


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient is laid out by
    ``grad_placements`` before it reaches the local tensor (the keyword
    that newer releases of ``from_local`` take)."""

    @staticmethod
    def forward(ctx, local, mesh, placements, grad_placements, shape,
                stride):
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.redistribute(ctx.mesh, ctx.grad_placements).to_local()
        return grad, None, None, None, None, None


def from_local(local: torch.Tensor, mesh, placements, shape,
               grad_placements=None) -> DTensor:
    """``local``, this rank's part, as a ``DTensor`` of global ``shape``
    (row-major) laid out by ``placements``; with ``grad_placements`` its
    gradient reaches ``local`` laid out by those (a ``Partial`` part whose
    every rank's share enters the sum once gets the whole gradient:
    ``Replicate``)."""
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    if grad_placements is None:
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)
    return _FromLocal.apply(local, mesh, tuple(placements),
                            tuple(grad_placements), shape, stride)


def local_offset(t: DTensor, dim: int):
    """The global index of this rank's first element of ``t`` along
    ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return offset[dim]


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
    decay = torch.exp(masked(tri[None, None, :, :, None], diff,
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
