"""Parameter definitions, initialisation and the hand-over from the JAX
reference's parameter trees.

Models declare their parameters once as a tree (nested dicts) of
:class:`ParamDef`, in the reference's layout: projection weights as
``(in, out)`` with heads split out (``wq (d, H, hd)``, ``wo (H, hd, d)``),
and a leading layers axis on every block parameter of a layer stack
(``common.stack_layer_defs``; the stacks are :data:`STACKS`: ``layers`` of
the dense transformer, Mamba2 and the hybrid, ``dense_layers`` and
``moe_layers`` of the MoE model).  A subtree that is no stack, such as the
hybrid's one ``shared`` block, maps to a submodule of that name.  From
that tree

* :func:`init_params` materialises tensors in that layout, from an explicit
  ``torch.Generator`` (the fan-in rule of the reference);
* :func:`abstract_params` gives ``meta``-device tensors of the same shapes,
  which allocate nothing (the reference's ``ShapeDtypeStruct`` tree);
* :func:`params_from_jax` turns such a tree, as numpy arrays or tensors,
  into the ``state_dict`` of the port's ``nn.Module``: each stack's layers
  axis split into one block per layer, projection weights in
  ``nn.Linear``'s ``(out, in)`` layout, and the MoE expert stacks
  (``w_gate``, ``w_up``, ``w_down``, ``(E, in, out)``) kept as stacked
  tensors in the reference's layout (as is Mamba2's ``conv_w``,
  ``(K, C)``, one per layer);
* :func:`params_to_jax` is its inverse;
* :func:`port_leaves` maps each of the tree's leaves to the port's tensors
  (the reference's leaf order, which the optimizer keeps), and
  :func:`decay_mask` reads AdamW's weight-decay rule off the tree's shapes.

The logical axes are the reference's: :func:`distribute` lays a network's
parameters (and :func:`distribute_tree` a cache) out on a ``DeviceMesh``
by them (``launch/sharding.py``), as ``DTensor``s, and ``launch/specs.py``
resolves them to per-device shapes to size a cell.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.launch import sharding as shd


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


def abstract_params(defs, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``meta``-device tensors of every :class:`ParamDef`'s shape (same
    tree): shapes and dtypes for sizing a model, no memory allocated."""
    out: dict = {}
    for path, d in _leaves(defs):
        _set(out, path, torch.empty(d.shape, dtype=dtype, device="meta"))
    return out


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))


#: top-level keys of the layer stacks: their leaves carry a leading layers
#: axis, split into one block module per layer
STACKS = ("layers", "dense_layers", "moe_layers")

#: projection weights of the reference's layout -> ``nn.Linear`` weights:
#: the number of leading input axes (flattened), the rest are outputs
#: (``wo`` takes heads and head width in; MLA's ``wuk``/``wuv``/``wuq`` take
#: a latent in and give heads out)
_LINEAR_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "wg": 1, "wu": 1,
                   "wd": 1, "out": 1, "wdq": 1, "wuq": 1, "wdkv": 1,
                   "wkr": 1, "wuk": 1, "wuv": 1, "router": 1, "w_in": 1,
                   "w_out": 1}
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


def _names(path: tuple, n_layers: int = 0):
    """The port names of the tree leaf at ``path``: one per layer of a
    stack (``n_layers`` of them), else one."""
    tail = path[1:-1] + (_port_name(path[-1]),)
    if path[0] in STACKS:
        return [".".join((path[0], str(i)) + tail) for i in range(n_layers)]
    return [".".join(path[:-1] + (_port_name(path[-1]),))]


def params_from_jax(tree, *, dtype: Optional[torch.dtype] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree -> the port's ``state_dict``.

    ``tree`` holds numpy arrays (``np.asarray`` of the JAX leaves) or
    tensors; the :data:`STACKS` are layer-stacked.  Leaf ``layers/wq`` of
    layer ``i`` becomes ``layers.{i}.wq.weight`` as ``(H*hd, d)``,
    ``layers/bq`` becomes ``layers.{i}.wq.bias``,
    ``moe_layers/shared/wg`` becomes ``moe_layers.{i}.shared.wg.weight``,
    ``moe_layers/w_gate`` stays ``(E, d, f)`` as ``moe_layers.{i}.w_gate``,
    top-level ``tok`` becomes ``tok.weight``.  Values are cast to ``dtype``
    if given; a leaf of a stack that needs no new layout is handed over as a
    view of the stacked tensor (no copy on the same device and dtype)."""
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
        if path[0] in STACKS:
            for i, name in enumerate(_names(path, t.shape[0])):
                state[name] = _to_port(leaf, t[i])
        else:
            state[_names(path)[0]] = _to_port(leaf, t)
    return state


def port_leaves(defs):
    """``(path, ParamDef, port names)`` for every leaf of ``defs``, in the
    reference's leaf order (``jax.tree.flatten``); a layer-stacked leaf
    names one port tensor per layer, in layer order."""
    for path, d in _leaves(defs):
        yield path, d, _names(path, d.shape[0] if path[0] in STACKS else 0)


def decay_mask(defs) -> Dict[str, bool]:
    """Port parameter name -> whether AdamW's weight decay applies, in the
    reference's leaf order.

    The reference decays every leaf of its tree with ``ndim >= 2``
    (``train/optimizer.py``), and its tree stacks the layers, so every
    per-layer leaf is decayed (norms, QKV biases, routers, expert stacks,
    the shared experts and Mamba2's ``A_log``, ``D`` and ``dt_bias``
    included), and of the top-level leaves all but ``final_norm`` and the
    hybrid's shared block's norms.  The rule is read from the
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
        stacked = path[0] in STACKS
        shape = d.shape[1:] if stacked else d.shape
        back = [(state[n].T if leaf in _LINEAR_IN_AXES else state[n]
                 ).reshape(shape) for n in names]
        a = torch.stack(back) if stacked else back[0]
        _set(out, path, a.detach().cpu().numpy())
    return out


def port_spec(leaf: str, spec_: tuple) -> tuple:
    """The spec of a leaf's port tensor from the spec of its reference
    layout (one layer's, without a stack's layers axis): an ``nn.Linear``
    weight is ``(out, in)`` with each group of axes flattened (a group is
    split like its first axis; the others are whole in every def), a
    per-head bias is flattened, every other leaf keeps its layout."""
    if leaf in _LINEAR_IN_AXES:
        n_in = _LINEAR_IN_AXES[leaf]
        groups = (spec_[n_in:], spec_[:n_in])
    elif leaf in _BIAS_OF:
        groups = (spec_,)
    else:
        return spec_
    if any(ax is not None for g in groups for ax in g[1:]):
        raise ValueError(f"{leaf}: split axis inside a flattened group "
                         f"{spec_}")
    return tuple(g[0] for g in groups)


def distribute(model, defs, mesh, rules) -> None:
    """Replace every parameter of ``model`` (built from ``defs``, its
    module's ``param_defs(cfg, tp)``) by a ``DTensor`` on the
    ``DeviceMesh`` ``mesh``, split by the def's logical axes under
    ``rules`` (axes that do not divide a dimension stay whole).  Each rank
    keeps its own shard of the values it holds, with no communication; a
    ``meta`` network gets ``meta`` shards."""
    for path, d, names in port_leaves(defs):
        stacked = path[0] in STACKS
        shape = d.shape[1:] if stacked else d.shape
        axes = d.axes[1:] if stacked else d.axes
        pl = shd.placements(mesh, port_spec(
            path[-1], shd.spec(mesh, rules, *axes, shape=shape)))
        for n in names:
            mod_name, _, attr = n.rpartition(".")
            mod = model.get_submodule(mod_name)
            old = getattr(mod, attr)
            new = distribute_tensor(old.detach(), mesh, pl,
                                    src_data_rank=None)
            setattr(mod, attr, torch.nn.Parameter(
                new, requires_grad=old.requires_grad))


def distribute_tree(tree: dict, defs: dict, mesh, rules) -> dict:
    """The tensors of ``tree`` (a cache: keys of ``defs``, the module's
    ``cache_defs``, in the reference's layout) as ``DTensor``s split by
    their defs' logical axes, each rank keeping its shard of what it holds;
    None entries stay None."""
    return {k: None if t is None else
            shd.constrain(t, mesh, rules, *defs[k].axes)
            for k, t in tree.items()}
