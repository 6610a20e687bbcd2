"""Logical-axis sharding rules, resolved to per-device shapes.

Every parameter and activation carries *logical* axis names
(``models/params.py``'s ``ParamDef.axes``); the rules map them onto mesh
axes, as the reference's do: training uses FSDP(data) x TP(model) x
DP(pod); serving uses DP(pod, data) x TP(model), and the decode KV cache
shards its length axis over the model axis.  A spec is a tuple with one
entry per dimension (None, a mesh axis, or a tuple of mesh axes): the
entries of the reference's ``PartitionSpec``.  :func:`shard_shape` is the
per-device shape of a spec; :func:`sharding` turns it into the
``DTensor`` placements of a ``DeviceMesh`` (one per mesh axis: ``Shard``
of the dimension that axis splits, else ``Replicate``) and
:func:`constrain` lays a tensor out by them, the reference's
``with_sharding_constraint``.  A mesh is the port's named
:class:`~repro_torch.launch.mesh.Mesh` or a ``DeviceMesh`` with axis
names (:func:`~repro_torch.launch.mesh.device_mesh`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import Mesh, device_mesh, named  # noqa: F401

Axis = Union[None, str, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple of mesh axes)
TRAIN_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "embed": "data",        # FSDP shard of the d_model axis of weights
    "tensor": "model",      # TP shard: heads / ffn / vocab / experts
    "experts": "model",     # EP rides the model axis
    "kv_seq": None,
    "seq": None,            # set to "model" for sequence parallelism
    "layers": None,
    "unsharded": None,
}

SERVE_RULES: Dict[str, Axis] = {
    **TRAIN_RULES,
    "embed": None,          # no FSDP at serving; weights TP-only
    "kv_seq": "model",      # decode cache length sharded (flash-decoding)
}


def _drop_missing(rules_axis: Axis, mesh: Mesh) -> Axis:
    names = set(mesh.axis_names)
    if rules_axis is None:
        return None
    if isinstance(rules_axis, str):
        return rules_axis if rules_axis in names else None
    kept = tuple(a for a in rules_axis if a in names)
    if not kept:
        return None
    # a singleton tuple and a bare string are distinct spec entries in the
    # reference's PartitionSpec; normalise like _fit_axes does
    return kept[0] if len(kept) == 1 else kept


def _fit_axes(dim: int, ax: Axis, mesh: Mesh) -> Axis:
    """Keep the longest prefix of mesh axes that evenly divides ``dim``
    (a global-batch-1 decode cell cannot shard its batch axis, etc.)."""
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else ax
    kept = []
    rem = dim
    for a in axes:
        sz = mesh.shape[a]
        if rem % sz == 0:
            kept.append(a)
            rem //= sz
        else:
            break
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def spec(mesh: Mesh, rules: Dict[str, Axis], *logical: Optional[str],
         shape: Optional[tuple] = None) -> tuple:
    """The mesh axes of each dimension of an array whose axes carry the
    given logical names.  With ``shape``, mesh axes that do not divide a
    dimension are pruned."""
    mesh = named(mesh)
    out = []
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        if name not in rules:
            raise KeyError(f"unknown logical axis {name!r}")
        ax = _drop_missing(rules[name], mesh)
        if shape is not None and ax is not None:
            ax = _fit_axes(shape[i], ax, mesh)
        out.append(ax)
    return tuple(out)


def shard_shape(shape: tuple, spec_: tuple, mesh: Mesh) -> tuple:
    """The per-device shape of an array of ``shape`` laid out by ``spec_``:
    each dimension divided by the product of its mesh axes' sizes (rounded
    up: a partitioner pads a dimension that does not divide)."""
    mesh = named(mesh)
    out = []
    for dim, ax in zip(shape, spec_):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(-(-dim // n))
    return tuple(out)


def placements(mesh, spec_: tuple) -> list:
    """The ``DTensor`` placements of ``spec_`` on the ``DeviceMesh``
    ``mesh``: per mesh axis ``Shard(dim)`` of the dimension it splits,
    else ``Replicate()``.  A dimension split over several axis (``("pod",
    "data")``) is split over them in mesh order, outermost first, as the
    reference's ``PartitionSpec``."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec_):
        for a in () if ax is None else (ax,) if isinstance(ax, str) else ax:
            out[names.index(a)] = Shard(dim)
    return out


def sharding(mesh, rules: Dict[str, Axis], *logical: Optional[str],
             shape: Optional[tuple] = None) -> list:
    """The placements of an array whose axes carry ``logical`` names (the
    reference's ``NamedSharding``)."""
    return placements(mesh, spec(mesh, rules, *logical, shape=shape))


def constrain(x, mesh, rules: Dict[str, Axis], *logical):
    """``x`` laid out by its logical axes on the ``DeviceMesh`` ``mesh``:
    a ``DTensor`` is redistributed (a collective where its placements
    differ), a plain tensor, which every rank holds whole, is cut to this
    rank's shard with no communication.  Axes that do not divide are left
    whole; a name list of the wrong rank leaves ``x`` as it is (the
    reference's ``with_sharding_constraint`` fails and it returns ``x``)."""
    if len(logical) != x.ndim:
        return x
    pl = sharding(mesh, rules, *logical, shape=tuple(x.shape))
    if isinstance(x, DTensor):
        return x if list(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def tree_specs(defs, mesh: Mesh, rules: Dict[str, Axis]):
    """Map a tree (nested dicts) of ParamDef (see models.params) to specs;
    None leaves stay None."""
    if isinstance(defs, dict):
        return {k: tree_specs(v, mesh, rules) for k, v in defs.items()}
    if defs is None:
        return None
    return spec(mesh, rules, *defs.axes, shape=defs.shape)
