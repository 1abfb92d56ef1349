"""Load a parameter tree in the JAX package's layout into the port's
modules.

The JAX package keeps a model's parameters as nested dicts with each
block-pattern position's layers stacked along a leading axis
(``groups/<i>/attn/wq`` of shape ``(group_count, d, hq, h)``), and an
encoder's layers likewise (``encoder/blocks/attn/wq`` of shape
``(encoder_layers, d, hq, h)``). The port's modules hold one layer each
(``groups.<i>.<g>.attn.wq``, ``encoder.blocks.<l>.attn.wq``), so loading
is a name map that splits the stacked axis. :func:`params_from_jax` takes that
tree as numpy arrays (the caller turns jax arrays into numpy; the port
never sees jax); :func:`load_tree` takes it as tensors. Both copy every
leaf into the model and raise on a leaf left over, a parameter missing, or
a shape that differs. :func:`draw_into`, what ``init`` runs, writes the
init rule's numbers into the modules leaf by leaf as they are drawn.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .layers import draw_params, tree_leaves


def stacked(parts: list[str]) -> bool:
    """Whether a JAX tree path (split at ``/``) names a stacked leaf:
    ``groups/<i>/<rest>`` or ``encoder/blocks/<rest>``, whose first two
    parts name the stack and whose leading axis is the layer."""
    return parts[0] == "groups" or parts[:2] == ["encoder", "blocks"]


def layer_name(parts: list[str], g: int) -> str:
    """The module parameter name of layer ``g`` of a stacked leaf:
    ``groups.<i>.<g>.<rest>`` or ``encoder.blocks.<g>.<rest>``."""
    return ".".join([*parts[:2], str(g), *parts[2:]])


def _targets(path: str, leaf) -> list[tuple[str, Any]]:
    """The module parameter name(s) of one JAX tree leaf and their values."""
    parts = path.split("/")
    if stacked(parts):
        return [(layer_name(parts, g), leaf[g])
                for g in range(leaf.shape[0])]
    return [(".".join(parts), leaf)]


@torch.no_grad()
def load_tree(model: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a JAX-layout tree of tensors into ``model``'s parameters (cast
    to their dtype and device); raises unless every leaf lands on a
    parameter of its shape and every parameter is written."""
    params = dict(model.named_parameters())
    written = set()
    leftover = []
    for path, leaf in tree_leaves(tree):
        for name, value in _targets(path, leaf):
            if name not in params:
                leftover.append(name)
                continue
            if tuple(value.shape) != tuple(params[name].shape):
                raise ValueError(
                    f"{path} -> {name}: shape {tuple(value.shape)} differs "
                    f"from the model's {tuple(params[name].shape)}")
            params[name].copy_(value)
            written.add(name)
    missing = sorted(set(params) - written)
    if leftover or missing:
        raise ValueError(f"parameter trees differ: {len(leftover)} leaves "
                         f"with no parameter {leftover[:5]}, {len(missing)} "
                         f"parameters with no leaf {missing[:5]}")
    return model


@torch.no_grad()
def draw_into(model: torch.nn.Module, specs: dict,
              generator: torch.Generator) -> torch.nn.Module:
    """``model``'s parameters drawn from ``generator`` by the reference's
    init rule (:func:`~repro_torch.models.layers.draw_params`), each leaf
    written into its parameters as it is drawn (cast to their dtype), so
    that no second tree is built: the model plus one float32 leaf (or
    slice) at a time. Raises unless every parameter is written."""
    params = dict(model.named_parameters())
    written = set()

    def write(path, spec, index, value):
        parts = path.split("/")
        if not stacked(parts):
            targets = [(".".join(parts), index, value)]
        elif index:                 # a slice of layer index[0]
            targets = [(layer_name(parts, index[0]), index[1:], value)]
        else:                       # the whole stack: layer g is value[g]
            targets = [(layer_name(parts, g), (),
                        value[g] if torch.is_tensor(value) else value)
                       for g in range(spec.shape[0])]
        for name, idx, v in targets:
            p = params[name][idx] if idx else params[name]
            if torch.is_tensor(v):
                p.copy_(v)
            else:
                p.fill_(v)
            written.add(name)

    draw_params(specs, generator, next(model.parameters()).device, write)
    missing = sorted(set(params) - written)
    if missing:
        raise ValueError(f"{len(missing)} parameters drawn by no leaf "
                         f"{missing[:5]}")
    return model


def params_from_jax(tree: dict, model: torch.nn.Module) -> torch.nn.Module:
    """``model`` (e.g. ``build_model(cfg).skeleton()``) with every
    parameter taken from the JAX package's tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``)."""

    def tensor(x) -> torch.Tensor:
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":      # ml_dtypes: no numpy bf16
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))  # a writable copy

    def to_tensors(t):
        return ({k: to_tensors(v) for k, v in t.items()}
                if isinstance(t, dict) else tensor(t))

    return load_tree(model, to_tensors(tree))
