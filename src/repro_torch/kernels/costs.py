"""What a kernel op costs and how it shards: the registrations that make
each model-path kernel a ``torch.library`` op the rest of torch can reason
about without running it.

:func:`register` gives an op (``torch.ops.repro_torch.<name>``):

- its FLOP formula in ``torch.utils.flop_counter``'s registry, which
  ``FlopCounterMode`` and the dry-run's per-device counter
  (:mod:`repro_torch.launch.roofline`) both read;
- its HBM bytes in :data:`BYTES`: each tensor operand read once and each
  output written once (:func:`io_bytes`), the count every op gets in the
  dry-run;
- its DTensor sharding rule (``register_sharding``): the placements, one
  mesh dim at a time, under which the kernel computes its share with no
  collective. DTensor redistributes the operands to one of them.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import register_flop_formula

#: OpOverloadPacket -> ``fn(args, kwargs, out) -> bytes`` for the kernel ops
BYTES: dict = {}


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a pytree, each counted once per
    occurrence (a view counts its own elements)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def io_bytes(args, kwargs, out) -> int:
    """Each tensor operand read once, each output written once."""
    return tensor_bytes((args, kwargs)) + tensor_bytes(out)


def placements(*dims) -> list:
    """One mesh dim's placements of an op's arguments (or outputs):
    ``None`` for a non-tensor argument, ``"R"`` for Replicate, an int
    ``d`` for ``Shard(d)``."""
    out = []
    for d in dims:
        out.append(None if d is None else Replicate() if d == "R"
                   else Shard(d))
    return out


def register(op, *, flops: Callable, rule: Callable) -> None:
    """Register ``op`` (an ``OpOverloadPacket``) with its FLOP formula
    (``flops(*shapes and arguments, out_shape=...)``, tensors passed as
    their shapes), the operand-and-output byte count and its sharding
    rule (``rule(*arguments) -> [(output placements, input
    placements), ...]``)."""
    register_flop_formula(op)(flops)
    BYTES[op] = io_bytes
    register_sharding(op.default)(rule)
