"""Logical-axis sharding rules (MaxText-style) over a ``torch.distributed``
device mesh.

Models name the logical axes of their parameters and activations; a
``Rules`` object maps them to the axes of a
:class:`torch.distributed.device_mesh.DeviceMesh`.  With no rules active
(one card, the CPU tests) every helper is a no-op and the same model code
runs unsharded.

The JAX package is single-controller: one process sees every device and
``shard_map`` runs a body per device.  The port is multi-controller: one
process per rank, each running the same program, and the explicit bodies
become explicit collectives on the process group of a mesh axis
(:func:`axis_group`, the twin of ``jax.lax.axis_index`` and an axis name).
A rank holds its own block of a sharded tensor (:func:`local_block`).
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.utils.tree import leaves, paths, unflatten

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]          # the PartitionSpec twin: one per dim

# logical axis -> mesh axis (single-pod default). ``batch`` picks up the
# extra ``pod`` axis on the multi-pod mesh.
SINGLE_POD_MAPPING = {
    "batch": "data",
    "fed_group": "data",          # federated groups live on the data axis
    "seq": None,
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "conv": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "classes": None,
    "stack": None,                # stacked-layer leading axis
}

MULTI_POD_OVERRIDES = {
    "batch": ("pod", "data"),
    "fed_group": ("pod", "data"),
}


def as_axes(axis: AxisVal) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh-axis names (none for None)."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Rules:
    def __init__(self, mesh, mapping: Optional[dict] = None):
        self.mesh = mesh
        m = dict(SINGLE_POD_MAPPING)
        if "pod" in mesh.mesh_dim_names:
            m.update(MULTI_POD_OVERRIDES)
        if mapping:
            m.update(mapping)
        self.mapping = m

    def with_overrides(self, **overrides) -> "Rules":
        """New Rules with some logical axes remapped (e.g. inside the fed
        group-local region, ``batch``/``seq`` must NOT claim the fed
        axes)."""
        m = dict(self.mapping)
        m.update(overrides)
        r = Rules.__new__(Rules)
        r.mesh = self.mesh
        r.mapping = m
        return r

    # -- spec construction -------------------------------------------------
    def _mesh_size(self, axis: AxisVal) -> int:
        return math.prod(mesh_size(self.mesh, a) for a in as_axes(axis))

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Mesh axes per dim for logical axes (the ``PartitionSpec``
        twin); drops mesh axes that don't divide."""
        parts = []
        for i, name in enumerate(logical):
            ax = self.mapping.get(name) if name else None
            if ax is not None and shape is not None:
                if shape[i] % self._mesh_size(ax) != 0:
                    ax = None  # non-divisible (e.g. smollm 9 heads on 16-way TP)
            parts.append(ax)
        return tuple(parts)


def mesh_size(mesh, axis: str) -> int:
    """The size of one named axis of ``mesh``."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axes_size(mesh, spec: Spec) -> int:
    """How many blocks ``spec`` cuts a tensor into on ``mesh``."""
    return math.prod(mesh_size(mesh, a) for ax in spec for a in as_axes(ax))


_local = threading.local()


def active_rules() -> Optional[Rules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The identity.  In the JAX package a sharding constraint only moves
    GSPMD's layout and the order of its reductions, never the values; the
    port computes such a layer replicated over the axes the constraint
    names."""
    return x


# The JAX package's ``shard_map`` version shim has no counterpart: a
# ``shard_map`` body here is the rank's own code, with its collectives on
# the groups of ``axis_group``.

# ----------------------------------------------------------------------
# a rank's place on the mesh
# ----------------------------------------------------------------------
# (id of a mesh, axis names) -> (a weak reference to that mesh, the
# group); the reference tells a live mesh from a later one at the address
# of a dead one
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


def axis_index(mesh, axis: AxisVal) -> Tuple[int, int]:
    """(this rank's index, size) along ``axis`` (a name or a tuple of
    names, the first the slowest) on ``mesh``: ``jax.lax.axis_index``."""
    coord = mesh.get_coordinate()
    index, size = 0, 1
    for a in as_axes(axis):
        n = mesh_size(mesh, a)
        index = index * n + coord[mesh.mesh_dim_names.index(a)]
        size *= n
    return index, size


def axis_group(mesh, axis: AxisVal) -> Tuple[Any, int, int]:
    """(process group, this rank's index, size) of ``axis`` on ``mesh``:
    the twin of an axis name in a ``shard_map`` body.  The group is None
    for an axis of size 1 (no collective is needed)."""
    names = as_axes(axis)
    index, size = axis_index(mesh, names)
    if size == 1:
        return None, index, 1
    if len(names) == 1:
        return mesh.get_group(names[0]), index, size
    # the ranks that differ from this one only on ``names``, in its order
    coord = mesh.get_coordinate()
    sub = mesh.mesh[tuple(slice(None) if d in names else coord[i]
                          for i, d in enumerate(mesh.mesh_dim_names))]
    order = [d for d in mesh.mesh_dim_names if d in names]
    ranks = tuple(int(r) for r in
                  sub.permute(*[order.index(a) for a in names]).reshape(-1))
    key = (id(mesh), names)
    entry = _GROUPS.get(key)
    if entry is None or entry[0]() is not mesh:
        entry = _GROUPS[key] = (weakref.ref(mesh), dist.new_group(
            list(ranks), use_local_synchronization=True))
    return entry[1], index, size


def local_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` (the whole tensor) under ``spec``: each
    dim cut into equal blocks over its mesh axes (a view)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        index, size = axis_index(mesh, axis)
        n = x.shape[dim] // size
        x = x.narrow(dim, index * n, n)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int
                   ) -> torch.Tensor:
    """The blocks ``x`` of the ``size`` ranks of ``group``, joined along
    ``dim`` in rank order (``jax.lax.all_gather(..., tiled=True)``)."""
    if group is None:
        return x
    x = x.contiguous()
    shape = tuple(x.shape)
    out = torch.empty((size * shape[0],) + shape[1:], dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.reshape((size,) + shape).unbind(0), dim=dim)


# ----------------------------------------------------------------------
# name-based parameter sharding: leaf path keywords -> logical axes per ndim.
_PARAM_LOGICAL = {
    "embed": ("vocab", "d_model"),
    "lm_head": ("d_model", "vocab"),
    "patch_proj": ("d_model", "d_model"),
    "wq": ("d_model", "heads"),
    "wk": ("d_model", "kv_heads"),
    "wv": ("d_model", "kv_heads"),
    "wo": ("heads", "d_model"),
    "w_gate": ("d_model", "ffn"),
    "w_up": ("d_model", "ffn"),
    "w_down": ("ffn", "d_model"),
    "router": ("d_model", None),
    # expert weights shard on the expert axis only (EP); ffn dim stays local
    "e_gate": ("experts", None, None),
    "e_up": ("experts", None, None),
    "e_down": ("experts", None, None),
    "in_proj": ("d_model", None),
    "out_proj": (None, "d_model"),
    "conv_w": ("conv", None),
    "a_log": (None,),
    "ssm_d": (None,),
    "dt_bias": (None,),
    # cnn / misc
    "conv1": (None, None, None, None),
    "conv2": (None, None, None, None),
    "fc1": (None, "ffn"),
    "fc2": ("ffn", None),
}


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a parameter given its ("/"-joined) tree path."""
    leaf = path.split("/")[-1]
    base = _PARAM_LOGICAL.get(leaf)
    if base is None:
        return (None,) * ndim
    if len(base) == ndim:
        return base
    if len(base) < ndim:
        # stacked over layers / hybrid groups / within-group index: any
        # number of leading 'stack' axes (jamba has two)
        return ("stack",) * (ndim - len(base)) + tuple(base)
    return (None,) * ndim


def param_specs(rules: Rules, params) -> list:
    """Each leaf's spec under ``rules``, in ``utils.tree`` leaf order."""
    return [rules.spec(logical_axes_for("/".join(p), x.dim()), x.shape)
            for p, x in zip(paths(params), leaves(params))]


def param_shardings(rules: Rules, params):
    """A tree of specs, shaped like ``params`` (by leaf path names)."""
    return unflatten(paths(params), param_specs(rules, params))


def gather_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (the
    inverse of :func:`local_block`): an all-gather over the axes of each
    sharded dim."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            group, _, size = axis_group(mesh, axis)
            x = all_gather_dim(x, dim, group, size)
    return x


# ----------------------------------------------------------------------
# collectives with the gradient of the single-program math
# ----------------------------------------------------------------------
# Under ``jax.shard_map(..., check_vma=False)`` ``jax.grad`` through a
# ``psum`` gives the gradient of the whole program: a replicated loss
# downstream sends each rank the same cotangent, and the psum passes it
# on unchanged.  ``torch.distributed.nn``'s all-reduce instead sums the
# cotangent over the group, which counts a replicated loss once per rank.
# So the pair below is Megatron's: ``psum`` reduces in the forward pass
# and passes the cotangent through; ``copy_to`` passes a replicated input
# through and sums the partial cotangents the ranks' shares send back.
# Each has a ``vmap`` rule (a collective is batch-transparent), so they
# run inside the federated round's ``torch.func.vmap`` of ``grad``.
def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Psum.apply(x, group), in_dims[0]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # through _Psum, so that the reduction also runs under vmap
        return _Psum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyTo.apply(x, group), in_dims[0]


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of ``group`` (``jax.lax.psum``); the cotangent
    passes through unchanged.  The identity for a group of None."""
    return x if group is None else _Psum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose cotangent is summed over ``group``: put it
    where a replicated tensor enters a computation each rank does a
    share of (an expert-parallel block)."""
    return x if group is None else _CopyTo.apply(x, group)


def pmean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The mean over the ranks of ``group`` (``jax.lax.pmean``); its
    cotangent is the replicated one over ``size``, this rank's share of
    the whole program's gradient."""
    return x if group is None else psum(x, group) / size


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum over the ranks of ``group`` (no gradient)."""
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)
