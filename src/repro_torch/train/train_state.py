"""Train step factory: loss, grads, AdamW update — model-agnostic.

The reference differentiates a pure loss with ``jax.value_and_grad``; here
the network is an ``nn.Module`` whose parameters require gradients, the
loss is differentiated with autograd, and the AdamW step of
``train/optimizer.py`` writes the new values back into the parameters.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import shard_batch
from repro_torch.models.layers import NOCTX, Ctx
from repro_torch.models.params import decay_mask
from repro_torch.train import optimizer as opt_lib


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Masked next-token CE.  labels < 0 are ignored; the mean runs over
    ``max(sum(valid), 1)`` tokens.  The gold logit is gathered (the
    reference selects it with an iota compare and a sum, which adds only
    zeros to it: the same value)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp_min(0).long()[..., None])
    nll = lse - gold[..., 0]
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    valid = valid.to(torch.float32)
    return torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1.0)


def _on(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_loss_fn(model, cfg, ctx: Ctx = NOCTX, aux_weight: float = 0.01):
    """``loss_fn(params, batch) -> (total, metrics)`` for the network
    ``params`` built by ``model.build`` (under ``ctx``'s mesh: laid out by
    ``params.distribute``).  Under a mesh the logits' vocabulary axis is
    gathered for the loss, whose sums run over the batch's shards."""
    def loss_fn(params, batch):
        batch = shard_batch(_on(batch, next(params.parameters()).device),
                            ctx)
        out = model.forward(params, batch, cfg, ctx)
        if isinstance(out, tuple):
            logits, aux = out
        else:
            logits, aux = out, 0.0
        logits = ctx.constrain(logits, "batch", "seq", None)
        with ctx.scope():
            loss = cross_entropy(logits, batch["labels"])
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux_loss": aux}
    return loss_fn


def make_train_step(model, cfg, opt_cfg: opt_lib.OptConfig,
                    ctx: Ctx = NOCTX):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` is the network (its parameters are updated in
    place and it is returned); ``opt_state`` is keyed by the network's
    parameter names, in the reference's leaf order
    (:func:`~repro_torch.models.params.decay_mask`).  Under ``ctx``'s mesh
    the parameters, gradients and moments are ``DTensor``s laid out alike
    (``init_state`` of the distributed parameters)."""
    loss_fn = make_loss_fn(model, cfg, ctx)
    decay = decay_mask(model.param_defs(cfg))

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        leaves = {k: named[k] for k in decay}
        with torch.enable_grad(), ctx.scope():
            total, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(total, list(leaves.values()))
        if ctx.mesh is not None:
            # each gradient laid out as its parameter (a partial sum is
            # reduced here: FSDP's reduce-scatter), as the reference's are
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves.values())]
        with torch.no_grad(), ctx.scope():
            new, opt_state, om = opt_lib.apply_updates(
                {k: p.detach() for k, p in leaves.items()},
                dict(zip(leaves, grads)), opt_state, opt_cfg, decay=decay)
            for k, p in leaves.items():
                p.copy_(new[k])
        metrics = {**{k: (v.detach() if torch.is_tensor(v) else v)
                      for k, v in metrics.items()},
                   **om, "total_loss": total.detach()}
        return params, opt_state, metrics

    return train_step
