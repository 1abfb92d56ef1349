"""Shared layers + the ParamSpec machinery (counterpart of
``repro/models/layers.py``).

Every parameter leaf is declared by a :class:`ParamSpec` carrying its
logical axes, in the JAX package's nested-dict tree, so the two packages'
parameter trees have the same paths, shapes and init rule. The logical
axes name how a leaf is sharded on a mesh: :func:`param_axes` reads them
and :mod:`repro_torch.launch.partitioning` turns them into placements;
:func:`abstract_params` gives the tree as meta tensors, with no
allocation.

The layout pins (``constrain``, ``constrain_bsd``, ``constrain_bshd``,
``gather_sp``), the reference's hints to XLA's partitioner, are explicit
``redistribute`` s here: on a DTensor under an ambient mesh
(:func:`repro_torch.compat.set_mesh`) each moves the tensor to the named
layout, with the placements :func:`repro_torch.launch.partitioning.
placements_of` makes of the spec; DTensor's op-by-op sharding
propagation does the rest, as GSPMD does around the reference's pins. A
mesh axis that does not divide its dim is dropped (replication, as the
rules do), since a kernel needs whole heads. On a plain tensor, or
outside a mesh, they do nothing.

The functions take and return tensors of the caller's dtype and compute
where the reference computes (norms, RoPE and softcaps in float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..compat import current_mesh

# logical axis vocabulary (the JAX package's launch/partitioning.py rules)
LAYERS, EMBED, MLP, VOCAB = "layers", "embed", "mlp", "vocab"
QHEADS, KVHEADS, HEADDIM = "q_heads", "kv_heads", "head"
LRU, SSM_INNER, SSM_STATE, SSM_HEADS = "lru", "ssm_inner", "ssm_state", "ssm_heads"
EXPERTS = "experts"
EXPERTS_DP = "experts_dp"  # a2a MoE layout: expert dim sharded over 'data'

#: A leaf of more elements than this is drawn one leading-axis slice at a
#: time by :func:`draw_params` (each float32 temporary at most 4 GiB).
DRAW_SLICE_ELEMENTS = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"     # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a tree of nested dicts, in sorted key
    order (jax's order for dicts), paths joined with ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend a stacked 'layers' axis to every spec in a tree."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (LAYERS, *s.axes), s.init, s.scale),
        specs,
    )


def param_axes(specs: Any) -> Any:
    """The tree of each leaf's logical axes."""
    return tree_map(lambda s: s.axes, specs)


def abstract_params(specs: Any, dtype: torch.dtype) -> Any:
    """The tree as tensors on the meta device (shape and dtype, no
    allocation): the counterpart of the reference's ``ShapeDtypeStruct``
    tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def _std(spec: ParamSpec) -> float:
    """The reference's init scale: ``scale / sqrt(fan_in)`` (``fan_in`` the
    second-last dim, or the last of a vector), 0.02 for ``embed`` and
    ``small``."""
    if spec.init in ("embed", "small"):
        return 0.02
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return float(spec.scale / np.sqrt(max(fan_in, 1)))


def init_params(specs: Any, generator: torch.Generator, dtype: torch.dtype,
                device) -> Any:
    """A tree of tensors for a tree of specs, drawn from ``generator`` (on
    ``device``) leaf by leaf in the tree's order. The reference's rule: zeros
    or ones where the spec says so; otherwise a float32 normal times
    :func:`_std`, cast to ``dtype``. The numbers differ from
    ``jax.random``'s for the same seed. :func:`draw_params` draws the same
    numbers without building the tree."""

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * _std(spec)).to(dtype)

    return tree_map(one, specs)


def spec_leaves(tree: Any, prefix: str = ""):
    """``(path, spec)`` of a spec tree in its own order (the order
    :func:`tree_map` visits, which is the order of the draws)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from spec_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def draw_params(specs: Any, generator: torch.Generator, device,
                write: Callable[[str, ParamSpec, tuple, Any], None]) -> None:
    """:func:`init_params`'s numbers, handed over as they are drawn:
    ``write(path, spec, index, value)`` for each leaf in the tree's order,
    ``value`` a float32 tensor (already scaled) or, for a ``zeros`` or
    ``ones`` leaf, the fill as a float, and ``index`` the leading-axis
    indices it fills (``()`` for the whole leaf). A leaf of more than
    :data:`DRAW_SLICE_ELEMENTS` elements is drawn one leading-axis slice
    at a time (recursively), which gives other numbers than one draw of
    the whole leaf; every leaf of the dense and state archs is smaller and
    is drawn whole, so their numbers are :func:`init_params`'s bit for
    bit. Each temporary is freed before the next is drawn."""

    def draw(path, spec, shape, index):
        if math.prod(shape) > DRAW_SLICE_ELEMENTS and len(shape) > 1:
            for i in range(shape[0]):
                draw(path, spec, shape[1:], (*index, i))
            return
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        write(path, spec, index, x.mul_(_std(spec)))
        del x

    for path, spec in spec_leaves(specs):
        if spec.init in ("zeros", "ones"):
            write(path, spec, (), 0.0 if spec.init == "zeros" else 1.0)
        else:
            draw(path, spec, spec.shape, ())


class ParamTree(torch.nn.Module):
    """An ``nn.Module`` tree of parameters, built from a tree of specs: a
    dict becomes a module whose children are its keys, a list a
    ``ModuleList`` of its items, a :class:`ParamSpec` an uninitialised
    parameter of its shape. Parameter names are the spec tree's paths
    joined with dots. ``node["key"]`` and ``"key" in node`` read a child or
    parameter, so layer code takes a module or a dict alike. Parameters
    require a gradient only when built ``trainable`` (training's); serving's
    do not."""

    def __init__(self, specs: dict, dtype: torch.dtype, device,
                 trainable: bool = False):
        super().__init__()
        for key, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(key, torch.nn.Parameter(
                    torch.empty(spec.shape, dtype=dtype, device=device),
                    requires_grad=trainable))
            elif isinstance(spec, list):
                self.add_module(key, torch.nn.ModuleList(
                    ParamTree(s, dtype, device, trainable) for s in spec))
            else:
                self.add_module(key, ParamTree(spec, dtype, device,
                                               trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# --------------------------------------------------------------------------- layout pins

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


def constrain(x: torch.Tensor, names: tuple) -> torch.Tensor:
    """``x`` redistributed to the layout ``names`` (one entry a dim: None,
    a mesh-axis name, or a tuple of them, major first) on its mesh, when
    ``x`` is a DTensor and a mesh is installed; otherwise ``x``. Axes
    absent from the mesh, already used, or not dividing the dim are
    dropped."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    from ..launch.partitioning import placements_of

    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    used: set = set()
    spec = []
    for dim, entry in zip(x.shape, names):
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        picked, size = [], 1
        for a in group:
            if a in sizes and a not in used and dim % (size * sizes[a]) == 0:
                picked.append(a)
                size *= sizes[a]
        used.update(picked)
        spec.append(tuple(picked) if picked else None)
    placements = placements_of(mesh, tuple(spec)).placements
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


class _GradLayout(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to the
    forward's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def keep_grad_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is brought back to ``x``'s own layout before
    it reaches ``x``'s producer (a DTensor view that splits a dim needs
    the gradient sharded as its output was); a plain tensor as it is."""
    if not isinstance(x, DTensor) or not torch.is_grad_enabled():
        return x
    return _GradLayout.apply(x)


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) residual-stream layout: batch over ('pod', 'data') and,
    when ``S > 1`` and the sequence divides the model axis, the sequence
    over 'model' (sequence parallelism, as the reference's)."""
    mesh = current_mesh()
    seq = None
    if isinstance(x, DTensor) and mesh is not None:
        n = dict(zip(x.device_mesh.mesh_dim_names,
                     x.device_mesh.shape)).get(MODEL_AXIS)
        if n is not None and x.shape[1] > 1 and x.shape[1] % n == 0:
            seq = MODEL_AXIS
    return constrain(x, (BATCH_AXES, seq, None))


def constrain_bshd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) attention layout: batch and heads sharded."""
    return constrain(x, (BATCH_AXES, None, MODEL_AXIS, None))


def gather_sp(x: torch.Tensor) -> torch.Tensor:
    """Leave the SP layout: the sequence whole, batch-only sharding."""
    return constrain(x, (BATCH_AXES, None, None))


# --------------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    scale = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(dt) * (1.0 + gamma.to(dt))


def rms_norm_spec(dim: int, axis_name: str = EMBED) -> ParamSpec:
    # gamma is stored as an offset from 1 (gemma convention) so zeros-init
    return ParamSpec((dim,), (axis_name,), init="zeros")


def qk_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm over the head dim (qwen3's qk_norm)."""
    return rms_norm(x, gamma, eps)


# --------------------------------------------------------------------------- softcap


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# --------------------------------------------------------------------------- RoPE


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / theta ** (np.arange(0, half, dtype=np.float32) / half)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10_000.0,
    mode: str = "full",
    sections: tuple[int, ...] = (),
) -> torch.Tensor:
    """Rotary embedding, three variants.

    x: (B, S, H, D). positions: (B, S) int — or (3, B, S) for mode='mrope'
    (temporal/height/width position streams, Qwen2-VL).

    full: rotate all D dims. half: rotate only the first D/2 dims (ChatGLM's
    2D/partial RoPE — the rest carries un-rotated content). mrope: the D/2
    frequency slots are split into `sections` groups, each driven by its own
    position stream.
    """
    d = x.shape[-1]
    if mode == "half":
        rot, keep = x.split(d // 2, dim=-1)
        return torch.cat(
            [apply_rope(rot, positions, theta=theta, mode="full"), keep], dim=-1
        )
    half = d // 2
    freqs = torch.from_numpy(rope_frequencies(d, theta)).to(x.device)
    if mode == "mrope":
        if positions.dim() != 3 or sum(sections) != half:
            raise ValueError(f"mrope needs (3, B, S) positions and sections "
                             f"summing to {half} (got {tuple(positions.shape)}, "
                             f"{sections})")
        parts = []
        start = 0
        for sec, pos in zip(sections, positions):
            parts.append(pos[..., None].to(torch.float32)
                         * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)                  # (B, S, half)
    else:
        angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- MLP


def mlp_specs(d_model: int, d_ff: int, act: str) -> dict[str, ParamSpec]:
    specs = {
        "w_up": ParamSpec((d_model, d_ff), (EMBED, MLP)),
        "w_down": ParamSpec((d_ff, d_model), (MLP, EMBED)),
    }
    if act in ("swiglu", "geglu"):
        specs["w_gate"] = ParamSpec((d_model, d_ff), (EMBED, MLP))
    return specs


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """``params``: a mapping (or module) with ``w_up``, ``w_down`` and, for
    the gated activations, ``w_gate``."""
    up = x @ params["w_up"]
    if act == "swiglu":
        up = F.silu(x @ params["w_gate"]) * up
    elif act == "geglu":
        up = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif act == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return up @ params["w_down"]


# --------------------------------------------------------------------------- embedding


def embed_specs(vocab: int, d_model: int, tie: bool) -> dict[str, ParamSpec]:
    specs = {"table": ParamSpec((vocab, d_model), (VOCAB, EMBED), init="embed")}
    if not tie:
        specs["head"] = ParamSpec((d_model, vocab), (EMBED, VOCAB))
    return specs


def _sharded_embedding(tokens: torch.Tensor, table: DTensor) -> DTensor:
    """The lookup of a DTensor table, vocab split over at most one
    mesh dim, through ``local_map``: each rank looks up the tokens its
    vocab shard holds and writes zeros elsewhere, a ``Partial`` sum over
    the vocab's mesh dim (Megatron's vocab-parallel embedding); the table
    is gathered on every other dim (FSDP). On one rank it is
    the plain lookup bit for bit."""
    mesh = table.device_mesh
    vocab = [m for m, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab) > 1:
        raise ValueError(f"embedding: the vocab split over {len(vocab)} "
                         "mesh dims")
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_pl = [Replicate() if m in vocab else p
              for m, p in enumerate(tokens.placements)]
    table_pl = [Shard(0) if m in vocab else Replicate()
                for m in range(mesh.ndim)]
    grad_pl = [Shard(0) if m in vocab else
               Partial() if isinstance(p, Shard) else Replicate()
               for m, p in enumerate(tok_pl)]
    out_pl = [Partial() if m in vocab else p for m, p in enumerate(tok_pl)]
    rows = table.shape[0] // (mesh.shape[vocab[0]] if vocab else 1)
    offset = mesh.get_local_rank(vocab[0]) * rows if vocab else 0

    def lookup(t, w):
        idx = t - offset
        inside = (idx >= 0) & (idx < w.shape[0])
        x = w[idx.clamp(0, w.shape[0] - 1)]      # as the plain path indexes
        return torch.where(inside[..., None], x, torch.zeros_like(x))

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tok_pl, table_pl),
                     in_grad_placements=(tok_pl, grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        tokens, table)


def embed_lookup(params, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    table = params["table"]
    x = (_sharded_embedding(tokens, table) if isinstance(table, DTensor)
         else table[tokens])
    # gemma-style sqrt(d) scaling keeps tied-embedding logits sane
    return x * torch.tensor(math.sqrt(d_model), dtype=x.dtype, device=x.device)


def embed_logits(params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["table"].T
