"""Logical-axis -> mesh-axis partitioner with divisibility fallback
(counterpart of ``repro/launch/partitioning.py``).

Model code declares *logical* axes per parameter dim
(:mod:`repro_torch.models.layers`); this module turns them into DTensor
placements on a mesh. The rule table is the reference's, and it is the
whole distribution policy:

  * tensor parallelism over "model" (heads / ffn / experts / vocab / lru /
    ssm channels);
  * FSDP over "data" on the `embed` dim of 2D+ weights;
  * batch over ("pod", "data");
  * decode KV caches shard their *sequence* dim over "model" (the
    split-KV layout, :func:`repro_torch.models.attention.decode_step_split_kv`).

If a dim isn't divisible by its candidate axis (seamless's 256206 vocab on
a 16-way model axis, or kv_heads=2 on model=16), the axis is dropped:
replication is the safe fallback. Each mesh axis shards at most one dim of
an array.

:meth:`Partitioner.spec` gives the reference's ``PartitionSpec`` entries as
a tuple: ``None``, an axis name, or a tuple of names. :meth:`Partitioner.
sharding` turns it into a :class:`Sharding`, ``(mesh, placements)`` with
one placement a mesh dim: ``Shard(d)`` on every mesh dim that shards
tensor dim ``d``, ``Replicate()`` elsewhere. A dim sharded over two axes
(``("pod", "data")``) gets ``Shard(d)`` on both mesh dims, major axis
first, which is how DTensor nests them: every rank holds the slice that
JAX's ``NamedSharding`` gives the device at its mesh position. The mesh is
a ``DeviceMesh`` or, for the rules alone, an
:class:`~repro_torch.compat.AbstractMesh`; :func:`device_put_tree` needs
a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..compat import mesh_axes

# logical axis -> ordered tuple of mesh axes to (jointly) shard over
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("data",),          # FSDP dim
    "mlp": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "experts": ("model",),
    "experts_dp": ("data",),     # a2a MoE layout (cfg.moe_layout="a2a")
    "lru": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "layers": (),
    "kv_seq": ("model",),        # decode cache: split-KV over model axis
    "seq": (),
}

Spec = tuple


class Sharding(NamedTuple):
    """Where an array lives: the mesh and one DTensor placement a mesh
    dim (the counterpart of ``NamedSharding``)."""

    mesh: Any
    placements: tuple


class Abstract(NamedTuple):
    """An array's shape, dtype and sharding, with no data (the
    counterpart of ``jax.ShapeDtypeStruct(..., sharding=)``)."""

    shape: tuple
    dtype: torch.dtype
    sharding: Sharding


def _map2(fn, tree, other):
    """``fn(leaf, other leaf)`` over two trees of nested dicts and lists of
    the same structure (a tuple of axis names is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_map2(fn, a, b) for a, b in zip(tree, other, strict=True)]
    return fn(tree, other)


@dataclasses.dataclass(frozen=True)
class Partitioner:
    mesh: Any
    rules: Any = None

    def _rules(self) -> dict[str, tuple[str, ...]]:
        return self.rules or DEFAULT_RULES

    # ------------------------------------------------------------- core
    def spec(self, shape: tuple[int, ...], axes: tuple[Optional[str], ...]
             ) -> Spec:
        """The PartitionSpec entries for one array, honoring divisibility
        and using each mesh axis once."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        sizes = mesh_axes(self.mesh)
        used: set[str] = set()
        parts: list = []
        for dim, name in zip(shape, axes):
            if name is None:
                parts.append(None)
                continue
            cand = [a for a in self._rules().get(name, ())
                    if a in sizes and a not in used]
            picked: list[str] = []
            size = 1
            for a in cand:
                if dim % (size * sizes[a]) == 0:
                    picked.append(a)
                    size *= sizes[a]
            used.update(picked)
            if not picked:
                parts.append(None)
            elif len(picked) == 1:
                parts.append(picked[0])
            else:
                parts.append(tuple(picked))
        return tuple(parts)

    def sharding(self, shape, axes) -> Sharding:
        return placements_of(self.mesh, self.spec(tuple(shape), tuple(axes)))

    # ------------------------------------------------------------- trees
    def tree_shardings(self, abstract_tree: Any, axes_tree: Any) -> Any:
        """A :class:`Sharding` tree for (a tree of tensors, meta or not,
        and the tree of their logical axes)."""
        return _map2(lambda leaf, ax: self.sharding(tuple(leaf.shape),
                                                    tuple(ax)),
                     abstract_tree, axes_tree)

    def tree_abstract(self, abstract_tree: Any, axes_tree: Any) -> Any:
        """The tree as :class:`Abstract` leaves, shardings attached."""
        return _map2(lambda leaf, ax: Abstract(
            tuple(leaf.shape), leaf.dtype,
            self.sharding(tuple(leaf.shape), tuple(ax))),
            abstract_tree, axes_tree)

    def batch_spec(self, ndim: int, batch_dim: int = 0) -> Spec:
        axes = [None] * ndim
        axes[batch_dim] = "batch"
        return self.spec(tuple([int(1e9)] * ndim), tuple(axes))  # always divisible

    def explain(self, shape, axes) -> str:
        return f"{tuple(shape)} {tuple(axes)} -> {self.spec(tuple(shape), tuple(axes))}"


def placements_of(mesh, spec: Spec) -> Sharding:
    """``(mesh, placements)`` for a spec: ``Shard(d)`` on each mesh dim that
    shards tensor dim ``d``. Names that shard one dim must come in the
    mesh's order (major first), the order DTensor nests them in."""
    names = list(mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: {group} is not in the mesh's "
                             f"order {tuple(names)}")
        for m in dims:
            placements[m] = Shard(d)
    return Sharding(mesh, tuple(placements))


def shard_slices(shape, sharding: Sharding, coordinate) -> tuple[slice, ...]:
    """The slice of an array of ``shape`` that the rank at mesh position
    ``coordinate`` holds under ``sharding`` (every sharded dim divides
    evenly, as the rules guarantee)."""
    sizes = [int(n) for n in sharding.mesh.shape]
    index = [0] * len(shape)
    count = [1] * len(shape)
    for m, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * sizes[m] + int(coordinate[m])
            count[p.dim] *= sizes[m]
    out = []
    for d, n in enumerate(shape):
        if n % count[d]:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into "
                             f"{count[d]}")
        step = n // count[d]
        out.append(slice(index[d] * step, (index[d] + 1) * step))
    return tuple(out)


def batch_shardings(part: Partitioner, batch_abstract: dict) -> dict:
    """Shardings for a batch dict: batch dim over ('pod', 'data').

    positions arrays for mrope are (3, B, S) — batch dim 1."""
    out = {}
    for k, v in batch_abstract.items():
        bdim = 1 if k == "positions" and v.dim() == 3 else 0
        axes: list = [None] * v.dim()
        axes[bdim] = "batch"
        out[k] = part.sharding(tuple(v.shape), tuple(axes))
    return out


def device_put_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf as a DTensor on its sharding's mesh and placements
    (``distribute_tensor``: rank 0's values, each rank keeping its
    shard)."""
    return _map2(lambda leaf, sh: distribute_tensor(
        leaf, sh.mesh, list(sh.placements)), tree, shardings)


# --------------------------------------------------------------------------- the port's per-layer leaves


def layer_sharding(sharding: Sharding, stacked: bool) -> Sharding:
    """The sharding of one layer of a stacked reference leaf: the leading
    ``layers`` dim (which the rules never shard) dropped, every ``Shard(d)``
    moved to ``Shard(d - 1)``; a plain leaf's as it is."""
    if not stacked:
        return sharding
    out = []
    for p in sharding.placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError(f"{sharding}: a stacked leaf sharded on "
                                 "its layers dim")
            p = Shard(p.dim - 1)
        out.append(p)
    return Sharding(sharding.mesh, tuple(out))


def _at(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def parameter_names(cfg) -> list[str]:
    """The port's parameter names for ``cfg`` (a ``ParamTree``'s, dotted,
    a list item by its index), in the module's order."""
    from ..models.layers import ParamSpec
    from ..models.transformer import layer_specs

    def walk(tree, prefix):
        if isinstance(tree, ParamSpec):
            yield prefix[:-1]
        elif isinstance(tree, list):
            for i, t in enumerate(tree):
                yield from walk(t, f"{prefix}{i}.")
        else:
            for k, v in tree.items():
                yield from walk(v, f"{prefix}{k}.")

    return list(walk(layer_specs(cfg), ""))


def param_shardings(bundle, mesh, tree=None) -> dict:
    """``{parameter name: Sharding}`` for the port's parameter names
    (``groups.0.3.attn.wq``): each reference leaf's sharding by the rules
    (or by ``tree``, a tree of :class:`Sharding` in the reference's layout,
    such as ``grad_shardings=``), one layer of it for a stacked leaf."""
    from ..train.checkpoint import reference_key

    if tree is None:
        tree = Partitioner(mesh).tree_shardings(bundle.abstract(),
                                                bundle.axes)
    out = {}
    for name in parameter_names(bundle.cfg):
        key = reference_key(name)
        stacked = key != name.replace(".", "/")   # a layer number dropped
        out[name] = layer_sharding(_at(tree, key), stacked)
    return out


def shard_tensor(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``t`` (the same full tensor on every rank) as a DTensor holding this
    rank's shard, with no collective (``DTensor.from_local`` of its slice);
    a DTensor passes through."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t
    mesh = sharding.mesh
    local = t[shard_slices(t.shape, sharding, mesh.get_coordinate())]
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh,
                              list(sharding.placements), run_check=False,
                              shape=t.shape, stride=stride)


def shard_module(module, bundle, mesh, shardings: Optional[dict] = None):
    """A new parameter module (a ``ParamTree`` of the bundle's names) whose
    parameters are DTensors in the rules' layout on ``mesh`` (or
    ``shardings``, name -> :class:`Sharding`) over this rank's slices of
    ``module``'s (:func:`shard_tensor`: no collective, and no copy where a
    slice is contiguous, as every leaf is on a one-rank mesh); each
    requires a gradient as its source does. ``module`` is left as it
    is."""
    from ..models.layers import ParamTree
    from ..models.transformer import layer_specs

    shardings = shardings or param_shardings(bundle, mesh)
    out = ParamTree(layer_specs(bundle.cfg),
                    getattr(torch, bundle.cfg.param_dtype), "meta")
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        out.get_submodule(".".join(path))._parameters[leaf] = \
            torch.nn.Parameter(shard_tensor(p.detach(), shardings[name]),
                               requires_grad=p.requires_grad)
    return out
