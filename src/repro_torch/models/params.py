"""Parameter definitions, initialisation and the hand-over from the JAX
reference's parameter trees.

Models declare their parameters once as a tree (nested dicts) of
:class:`ParamDef`, in the reference's layout: projection weights as
``(in, out)`` with heads split out (``wq (d, H, hd)``, ``wo (H, hd, d)``),
and a leading ``layers`` axis on every block parameter
(``common.stack_layer_defs``).  From that tree

* :func:`init_params` materialises tensors in that layout, from an explicit
  ``torch.Generator`` (the fan-in rule of the reference);
* :func:`params_from_jax` turns such a tree, as numpy arrays or tensors,
  into the ``state_dict`` of the port's ``nn.Module``: the layers axis split
  into one block per layer, and projection weights in ``nn.Linear``'s
  ``(out, in)`` layout;
* :func:`params_to_jax` is its inverse;
* :func:`port_leaves` maps each of the tree's leaves to the port's tensors
  (the reference's leaf order, which the optimizer keeps), and
  :func:`decay_mask` reads AdamW's weight-decay rule off the tree's shapes.

The reference's sharding-only helpers (``abstract_params`` and the logical
axes' partition specs) have no counterpart on one card; the axes are kept as
documentation of each dimension.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones | scaled
    fan_in: Optional[int] = None      # for scaled init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted key order (the order of
    ``jax.tree.flatten`` over dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(defs, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Tensors for every :class:`ParamDef` of ``defs`` (same tree):
    ``zeros``/``ones`` as named, otherwise normal draws scaled by
    ``1/sqrt(fan_in)`` (``fan_in`` if given, else the second-to-last
    dimension, else the last).  Draws are f32 from ``generator`` (which
    must live on ``device``), then cast to ``dtype``."""
    out: dict = {}
    for path, d in _leaves(defs):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            fan = d.fan_in if d.fan_in else (d.shape[-2] if len(d.shape) >= 2
                                             else d.shape[-1])
            scale = 1.0 / math.sqrt(max(fan, 1))
            t = (torch.randn(d.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 * scale).to(dtype)
        _set(out, path, t)
    return out


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))


#: projection weights of the reference's layout -> ``nn.Linear`` weights:
#: the number of leading input axes (flattened), the rest are outputs
_LINEAR_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "wg": 1, "wu": 1,
                   "wd": 1, "out": 1}
#: per-head biases -> the bias of their projection
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv"}


def _port_name(leaf: str) -> str:
    if leaf in _LINEAR_IN_AXES or leaf == "tok":
        return f"{leaf}.weight"
    if leaf in _BIAS_OF:
        return f"{_BIAS_OF[leaf]}.bias"
    return leaf


def _to_port(leaf: str, t: torch.Tensor) -> torch.Tensor:
    if leaf in _LINEAR_IN_AXES:
        n_in = math.prod(t.shape[:_LINEAR_IN_AXES[leaf]])
        return t.reshape(n_in, -1).T.contiguous()
    if leaf in _BIAS_OF:
        return t.reshape(-1)
    return t


def params_from_jax(tree, *, dtype: Optional[torch.dtype] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree -> the port's ``state_dict``.

    ``tree`` holds numpy arrays (``np.asarray`` of the JAX leaves) or
    tensors; ``tree["layers"]`` is layer-stacked.  Leaf ``layers/wq`` of
    layer ``i`` becomes ``layers.{i}.wq.weight`` as ``(H*hd, d)``,
    ``layers/bq`` becomes ``layers.{i}.wq.bias``, top-level ``tok`` becomes
    ``tok.weight``.  Values are cast to ``dtype`` if given."""
    state: Dict[str, torch.Tensor] = {}
    for path, a in _leaves(tree):
        if isinstance(a, np.ndarray) and a.dtype.kind == "V":
            raise TypeError(f"{'/'.join(path)}: cast bfloat16 leaves to "
                            "float32 before handing them over")
        # numpy leaves are copied: JAX hands out read-only buffers
        t = (a if isinstance(a, torch.Tensor)
             else torch.tensor(np.asarray(a))).to(device)
        if dtype is not None:
            t = t.to(dtype)
        leaf = path[-1]
        if path[0] == "layers":
            for i in range(t.shape[0]):
                state[f"layers.{i}.{_port_name(leaf)}"] = _to_port(leaf, t[i])
        else:
            state[".".join(path[:-1] + (_port_name(leaf),))] = \
                _to_port(leaf, t)
    return state


def port_leaves(defs):
    """``(path, ParamDef, port names)`` for every leaf of ``defs``, in the
    reference's leaf order (``jax.tree.flatten``); a layer-stacked leaf
    names one port tensor per layer, in layer order."""
    for path, d in _leaves(defs):
        leaf = path[-1]
        if path[0] == "layers":
            names = [f"layers.{i}.{_port_name(leaf)}"
                     for i in range(d.shape[0])]
        else:
            names = [".".join(path[:-1] + (_port_name(leaf),))]
        yield path, d, names


def decay_mask(defs) -> Dict[str, bool]:
    """Port parameter name -> whether AdamW's weight decay applies, in the
    reference's leaf order.

    The reference decays every leaf of its tree with ``ndim >= 2``
    (``train/optimizer.py``), and its tree stacks the layers, so every
    per-layer leaf is decayed, norms and QKV biases included, and of the
    top-level leaves all but ``final_norm``.  The rule is read from the
    reference's shapes (``defs``), never from the port tensor's ``ndim``:
    a port block's norm is 1-D, its stacked counterpart 2-D."""
    return {n: len(d.shape) >= 2
            for _, d, names in port_leaves(defs) for n in names}


def params_to_jax(state: Dict[str, torch.Tensor], defs) -> dict:
    """Inverse of :func:`params_from_jax`: the port's ``state_dict`` ->
    numpy arrays in the reference's layout, shaped by ``defs`` (the model's
    ``param_defs``)."""
    out: dict = {}
    for path, d, names in port_leaves(defs):
        leaf = path[-1]
        stacked = path[0] == "layers"
        shape = d.shape[1:] if stacked else d.shape
        back = [(state[n].T if leaf in _LINEAR_IN_AXES else state[n]
                 ).reshape(shape) for n in names]
        a = torch.stack(back) if stacked else back[0]
        _set(out, path, a.detach().cpu().numpy())
    return out
