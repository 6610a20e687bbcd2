"""AdamW on tensors with schedule, clipping, and optional gradient
compression — the reference's ``train/optimizer.py`` as plain functions.

* decoupled weight decay on the leaves the reference decays: its rule is
  ``ndim >= 2`` over its layer-stacked tree, so a caller holding the port's
  per-layer tensors passes ``decay`` (``models.params.decay_mask``);
* global-norm gradient clipping;
* warmup + cosine schedule;
* optimizer-state dtype is configurable (``bfloat16`` moments are stored
  rounded to bf16 and updated in f32);
* ``topk_compress``: error-feedback top-k gradient compression.

A *tree* here is a flat dict ``name -> tensor``, walked in insertion
order: the trainer builds it in the reference's leaf order, so the global
norm sums leaves in the order the reference does.  The schedule and the
bias corrections are computed in f32 from an int32 step, as the
reference's are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # float32 | bfloat16
    grad_compression: float = 0.0    # 0 = off; else keep-fraction for top-k


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int32 tensor or an int), as an f32
    tensor."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: Tree, cfg: OptConfig) -> dict:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def clip_by_global_norm(grads: Tree, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def apply_updates(params: Tree, grads: Tree, opt_state: dict,
                  cfg: OptConfig, decay: Optional[Dict[str, bool]] = None):
    """One AdamW step; returns (new_params, new_opt_state, metrics).

    ``decay[name]`` says whether weight decay applies to a leaf; without
    it, leaves with ``ndim >= 2`` are decayed (the reference's rule, right
    for trees in the reference's layout)."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g32 = grads[k].to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        decays = p.ndim >= 2 if decay is None else decay[k]
        if decays and cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[k] = m32.to(m.dtype)
        new_v[k] = v32.to(v.dtype)
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


# -- gradient compression (error feedback top-k) ----------------------------

def topk_compress(grad: torch.Tensor, residual: torch.Tensor,
                  keep_frac: float):
    """Error-feedback top-|g| sparsification of one gradient tensor.

    Returns (sparse_grad, new_residual).  The sparse gradient is
    dense-shaped with zeros off-support; ``residual`` accumulates what was
    dropped.  Entries tied with the k-th largest magnitude are all kept."""
    g = grad.to(torch.float32) + residual.to(torch.float32)
    k = max(1, int(math.ceil(keep_frac * g.numel())))
    thresh = torch.topk(torch.abs(g).reshape(-1), k).values[-1]
    mask = (torch.abs(g) >= thresh).to(torch.float32)
    sparse = g * mask
    return sparse.to(grad.dtype), (g - sparse).to(residual.dtype)


def compress_tree(grads: Tree, residuals: Tree, keep_frac: float):
    outs = {k: topk_compress(g, residuals[k], keep_frac)
            for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})
