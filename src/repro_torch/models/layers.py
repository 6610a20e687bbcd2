"""Dense building blocks of the transformer, in plain torch ops.

Each function computes what its namesake in the reference
(``src/repro/models/layers.py``) computes, with the same dtype handling
(norms, rope and softmax in f32; products in the working dtype), so the
forward pass can be held to the reference's.  Attention is written out with
``einsum`` and ``softmax`` rather than a fused library operator, which
would round otherwise.  Two schedules:

* :func:`attn_full`    — materialised scores (sequences up to 2048);
* :func:`attn_chunked` — blockwise online softmax over q and kv blocks, so a
  long sequence never materialises an ``S x S`` score tensor.

The reference's sharding context (``Ctx``) has no counterpart on one card.
MoE, SSD, convolution and decode-cache helpers come with their models.
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
