"""Abstract inputs for every (arch x shape) cell: ``meta`` tensors of their
global shapes, each with its spec and per-device shape on a mesh.

The reference's ``ShapeDtypeStruct`` stand-ins with shardings.  A
:class:`Spec` holds a ``meta`` tensor (global shape and dtype, no memory),
the spec of the logical axes of its def (``launch/sharding.py``) and the
per-device shape that spec gives; the trees follow the model modules'
``param_defs`` / ``cache_defs`` (``models/params.py``'s ``ParamDef``,
the reference's layout and logical axes).  :func:`abstract_model` builds a
network of a config on ``meta`` (the model classes under
``torch.device("meta")``), which the dry-run runs the cell's step on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import hybrid, mamba2, moe, transformer
from repro_torch.models.common import cache_dtype

#: model family -> network class
MODEL_CLASSES = {"dense": transformer.Transformer, "moe": moe.MoEModel,
                 "ssm": mamba2.Mamba2Model, "hybrid": hybrid.HybridModel}


@dataclasses.dataclass(frozen=True)
class Spec:
    """One abstract array: ``tensor`` (``meta``, global shape and dtype),
    its ``spec`` (mesh axes per dimension) and ``local_shape`` (per
    device)."""

    tensor: torch.Tensor
    spec: tuple
    local_shape: tuple

    @property
    def nbytes(self) -> int:
        """Bytes on one device."""
        return math.prod(self.local_shape) * self.tensor.element_size()


def _spec(shape, dtype, mesh: Mesh, rules, *axes) -> Spec:
    s = shd.spec(mesh, rules, *axes, shape=shape)
    return Spec(torch.empty(shape, dtype=dtype, device="meta"), s,
                shd.shard_shape(shape, s, mesh))


def _tree(defs, fn):
    if isinstance(defs, dict):
        return {k: _tree(v, fn) for k, v in defs.items()}
    return None if defs is None else fn(defs)


def _moment_dtype(cfg: ModelConfig) -> str:
    # bf16 moments for the largest models (see optimizer.py docstring)
    return "bfloat16" if cfg.param_count() > 1e11 else "float32"


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules,
                dtype=torch.bfloat16) -> Dict[str, Spec]:
    """Token ids (int32) and, for a modality frontend, its ``dtype``
    embeddings; decode takes one new token per sequence."""
    B, S = shape.global_batch, shape.seq_len
    prefix = cfg.frontend_prefix if cfg.frontend != "none" else 0
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32, mesh, rules,
                                "batch", None)}
    out = {"tokens": _spec((B, S - prefix), torch.int32, mesh, rules,
                           "batch", None)}
    if shape.kind == "train":
        out["labels"] = _spec((B, S), torch.int32, mesh, rules,
                              "batch", None)
    if prefix:
        out["embeds"] = _spec((B, prefix, cfg.d_model), dtype, mesh, rules,
                              "batch", None, None)
    return out


def cache_specs(cfg: ModelConfig, mod, shape: ShapeConfig, mesh: Mesh,
                rules, dtype=torch.bfloat16) -> Dict[str, Spec]:
    """The decode cache of ``shape`` (``global_batch`` sequences of
    ``seq_len`` positions) in the port's dtypes (``common.cache_dtype``)."""
    defs = mod.cache_defs(cfg, shape.global_batch, shape.seq_len)
    return {k: None if d is None else
            _spec(d.shape, cache_dtype(k, dtype), mesh, rules, *d.axes)
            for k, d in defs.items()}


def param_specs(cfg: ModelConfig, mod, mesh: Mesh, rules, tp: int,
                dtype=torch.bfloat16):
    """The parameter tree (``param_defs`` with heads padded to ``tp``)."""
    return _tree(mod.param_defs(cfg, tp),
                 lambda d: _spec(d.shape, dtype, mesh, rules, *d.axes))


def opt_specs(cfg: ModelConfig, mod, mesh: Mesh, rules, tp: int,
              state_dtype=torch.float32):
    """AdamW's moments (laid out as the parameters) and its int32 step."""
    p = param_specs(cfg, mod, mesh, rules, tp, dtype=state_dtype)
    return {"m": p, "v": p, "step": _spec((), torch.int32, mesh, rules)}


def logits_spec(cfg: ModelConfig, B: int, S: int, mesh: Mesh, rules,
                dtype=torch.bfloat16) -> Spec:
    return _spec((B, S, cfg.vocab_padded()), dtype, mesh, rules,
                 "batch", None, "tensor")


def nbytes(tree) -> int:
    """Per-device bytes of every :class:`Spec` in ``tree``."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return 0 if tree is None else tree.nbytes


def tensors(tree):
    """The ``meta`` tensors of a tree of :class:`Spec` (same tree)."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return None if tree is None else tree.tensor


def abstract_model(cfg: ModelConfig, dtype: torch.dtype, *,
                   train: bool, tp: int = 1) -> torch.nn.Module:
    """A network of ``cfg`` on ``meta`` in ``dtype`` (heads padded to a
    multiple of ``tp``): trainable (parameters require gradients) or built
    for inference."""
    with torch.device("meta"):
        net = MODEL_CLASSES[cfg.family](cfg, tp)
    net = net.to(dtype)
    return net.requires_grad_(train).train(train)
