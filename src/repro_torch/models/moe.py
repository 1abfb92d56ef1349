"""Mixture-of-Experts with expert-parallel dispatch (counterpart of
``repro/models/moe.py``).

Routing is GShard/Switch-style top-k with capacity and drop: a token's
rank within an expert comes from a one-hot cumulative sum over the
``(T·k)`` stream of (token, slot) pairs in token-major order, and the
pairs past ``capacity`` are dropped (their gate mass does not contribute;
the residual stream carries the token). Dispatch writes each kept pair's
token into its expert's slot of an ``(E·capacity, D)`` buffer and combine
gathers it back weighted by the gate, so memory stays about twice the
activations. No Pallas kernel carries MoE in the JAX package (its expert
products are ``jnp.einsum``); here they are ``torch.bmm``.

Three execution paths with the reference's arithmetic:

* local (``ep.mesh is None``): the whole expert set on this device;
* gather layout (``moe_layout="gather"`` on a mesh with ``ep.ep_axis``):
  each rank takes its batch block over ``ep.dp_axes`` and its
  ``E / ep_size`` experts, routes over the global expert set, computes its
  experts' share, and a sum over the expert axis adds the shares;
* all-to-all layout (``moe_layout="a2a"``): experts over ``data``, each
  expert's F over ``model``. Weights never move; tokens do: each rank
  sends its capacity slots to the experts' owners with one all-to-all
  (bfloat16 on the wire, forward and backward) and gets the outputs back
  with another, and a sum over ``model`` adds the F-partials.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are taken from ``("pod", "data", "model")``; the JAX
package's ``shard_map`` becomes each rank slicing the full tensors it is
handed (experts by its rank on the expert axis, F by its rank on
``model``, the batch by its rank on the batch axes) and collectives on
``mesh.get_group(axis)``. The caller hands every rank the same full
``x`` and parameters, and every rank returns the full output and aux
losses, as the reference's global arrays are. Gradients follow the same
rule: the region's inputs pass through :class:`_Enter`, whose backward
sums the ranks' partial gradients over the axes that split the work, so
that every rank ends with the gradient the local path gives (the aux
losses, equal on the ranks of the expert or model axis, enter that sum
once through :class:`_Sum`'s divisor). Sharded parameters, where each rank
keeps only its own experts, wait for the dry-run slice (``ROADMAP.md``
queue 1 item 3): the mesh (:mod:`repro_torch.launch.mesh`) is ported, and
its rules say which experts a rank would keep, but every rank is handed
them all.

Aux losses (load balance and router z) are computed from the full router
distribution and averaged over the batch axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..compat import mesh_axes
from ..configs.base import ModelConfig
from .layers import EMBED, EXPERTS, EXPERTS_DP, MLP, ParamSpec, mlp_apply, mlp_specs


@dataclasses.dataclass(frozen=True)
class EPContext:
    """How the MoE layer parallelizes. None mesh => local path."""

    mesh: Optional[Any] = None      # torch.distributed DeviceMesh
    ep_axis: str = "model"
    dp_axes: tuple[str, ...] = ("data",)


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    if cfg.moe_layout == "a2a":
        # experts over 'data' (dp-EP), per-expert F over 'model' (TP)
        ax_up = (EXPERTS_DP, EMBED, MLP)
        ax_down = (EXPERTS_DP, MLP, EMBED)
    else:
        ax_up = (EXPERTS, EMBED, MLP)
        ax_down = (EXPERTS, MLP, EMBED)
    specs: dict = {
        "router": ParamSpec((d, e), (EMBED, None), init="small"),
        "w_gate": ParamSpec((e, d, f), ax_up),
        "w_up": ParamSpec((e, d, f), ax_up),
        "w_down": ParamSpec((e, f, d), ax_down),
    }
    if cfg.moe_dense_residual:
        specs["dense"] = mlp_specs(d, cfg.moe_dense_d_ff or cfg.d_ff, cfg.act)
    return specs


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    return max(
        int(np.ceil(cfg.capacity_factor * cfg.top_k * tokens / cfg.num_experts)), 1
    )


# --------------------------------------------------------------------------- stages


class Routing(NamedTuple):
    logits: torch.Tensor       # (T, E) float32
    probs: torch.Tensor        # (T, E) float32
    gates: torch.Tensor        # (T, k) float32, renormalised over the k
    ids: torch.Tensor          # (T·k,) expert of each pair, token-major
    pos: torch.Tensor          # (T·k,) rank of the pair within its expert
    keep: torch.Tensor         # (T·k,) pos < capacity


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           capacity: int, ids: Optional[torch.Tensor] = None) -> Routing:
    """The float32 router, top-k, and each (token, slot) pair's rank within
    its expert from the one-hot cumulative sum. ``ids`` (``(T·k,)``, the
    experts of another run) replaces the top-k, the gates then read from
    this run's probabilities at those experts: one routing imposed on two
    arithmetics, which the on-card checks compare without the
    discontinuity of routing between them."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    if ids is None:
        gates, expert_ids = _top_k(probs, cfg.top_k)
    else:
        expert_ids = ids.reshape(-1, cfg.top_k)
        gates = probs.gather(1, expert_ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    ids = expert_ids.reshape(-1)
    onehot = F.one_hot(ids, cfg.num_experts)
    pos = onehot.cumsum(0).gather(1, ids[:, None])[:, 0] - 1
    return Routing(logits, probs, gates, ids, pos, pos < capacity)


def _aux_losses(r: Routing, cfg: ModelConfig):
    """Switch load balance, E · sum_e f_e · p_e over the global expert set,
    and the router z loss."""
    e, k = cfg.num_experts, cfg.top_k
    frac = torch.bincount(r.ids, minlength=e).to(torch.float32) \
        / r.ids.numel() * k
    lb = e * torch.sum(frac / k * r.probs.mean(dim=0))
    z = torch.logsumexp(r.logits, dim=-1).square().mean()
    return lb, z


def _dispatch(x2d: torch.Tensor, dest: torch.Tensor, k: int,
              slots: int) -> torch.Tensor:
    """``(slots, D)``: each pair's token in its slot ``dest``, zeros in the
    slots no pair took. Kept destinations are unique, so this is an index
    assignment (deterministic); a dropped pair (``dest == slots``) lands in
    a spare row that is cut off, the reference's ``mode="drop"``."""
    buf = x2d.new_zeros(slots + 1, x2d.shape[1])
    buf = buf.index_put((dest,), x2d.repeat_interleave(k, dim=0))
    return buf[:slots]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product in the two operands' promoted dtype, as ``jnp.einsum``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dt), b.to(dt))


def _experts(h: torch.Tensor, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    """Each expert's FFN over its ``(E, C, D)`` slots."""
    up = _matmul(h, w_up)
    if act in ("swiglu", "geglu"):
        gate = _matmul(h, w_gate)
        gate = F.silu(gate) if act == "swiglu" else F.gelu(gate,
                                                           approximate="tanh")
        up = gate * up
    else:
        up = F.gelu(up, approximate="tanh")
    return _matmul(up, w_down)


def _combine(y_flat: torch.Tensor, dest: torch.Tensor, weight: torch.Tensor,
             t: int, k: int) -> torch.Tensor:
    """``(T, D)``: each token's pairs' slot outputs weighted by their gates
    and summed; a dropped pair reads the last slot with weight 0."""
    contrib = y_flat[dest.clamp_max(y_flat.shape[0] - 1)]
    return (contrib * weight[:, None]).reshape(t, k, -1).sum(dim=1)


def _route_and_compute(
    x2d: torch.Tensor,         # (T, D) this rank's tokens
    params,
    cfg: ModelConfig,
    e_start: int,              # first global expert id on this rank
    e_local: int,              # experts on this rank
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y2d partial output, lb_loss, z_loss). fp32 router."""
    t, d = x2d.shape
    k = cfg.top_k
    r = _route(x2d, params["router"], cfg, capacity)
    local_sel = (r.ids >= e_start) & (r.ids < e_start + e_local) & r.keep
    slots = e_local * capacity
    dest = torch.where(local_sel, (r.ids - e_start) * capacity + r.pos,
                       slots)
    h = _dispatch(x2d, dest, k, slots).reshape(e_local, capacity, d)
    y = _experts(h, params["w_gate"] if "w_gate" in params else None,
                 params["w_up"], params["w_down"], cfg.act)
    weight = (r.gates.reshape(-1) * local_sel).to(x2d.dtype)
    y2d = _combine(y.reshape(slots, d), dest, weight, t, k)
    lb, z = _aux_losses(r, cfg)
    return y2d, lb, z


# --------------------------------------------------------------------------- collectives


def _groups(mesh, axes) -> list:
    return [mesh.get_group(a) for a in axes]


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients
    over ``groups`` (the axes that split the work), so that each rank holds
    the whole gradient of the replicated input."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _Sum(torch.autograd.Function):
    """The sum over ``groups`` divided by ``n`` forward; the backward hands
    each rank its (replicated) cotangent divided by ``n``, which
    :class:`_Enter` sums."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        y = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y / n if n != 1 else y

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if ctx.n != 1 else g), None, None


def _batch_axes(mesh, names) -> list:
    """``[(group, size, rank)]`` of this rank on the mesh axes ``names``."""
    sizes = mesh_axes(mesh)
    return [(mesh.get_group(a), sizes[a], mesh.get_local_rank(a))
            for a in names]


def _block_index(axes) -> tuple[int, int]:
    """(this rank's block, blocks) along dim 0 over ``axes`` =
    :func:`_batch_axes`, outer axis first (row-major, as a
    ``PartitionSpec`` over several axes)."""
    index, blocks = 0, 1
    for _, size, rank in axes:
        index, blocks = index * size + rank, blocks * size
    return index, blocks


def _block(x: torch.Tensor, axes) -> torch.Tensor:
    """This rank's block of ``x`` along dim 0 over ``axes``."""
    index, blocks = _block_index(axes)
    n = x.shape[0] // blocks
    return x[index * n:(index + 1) * n]


class _Gather(torch.autograd.Function):
    """Concatenate the ranks' blocks along dim 0 over ``axes`` (as
    :func:`_block` cuts them); the backward takes this rank's block."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.index, ctx.blocks = _block_index(axes)
        y = x.contiguous()
        for group, size, _ in reversed(axes):
            parts = [torch.empty_like(y) for _ in range(size)]
            dist.all_gather(parts, y, group=group)
            y = torch.cat(parts, dim=0)
        return y

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.blocks
        return g[ctx.index * n:(ctx.index + 1) * n], None


def _a2a_bf16(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all along dim 0 in bfloat16."""
    send = x.to(torch.bfloat16).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


class _A2AWire(torch.autograd.Function):
    """Tiled all-to-all whose wire dtype is bfloat16 in both the forward
    and the backward (the all-to-all is its own transpose), as the
    reference's ``custom_vjp`` pins it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return _a2a_bf16(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _a2a_bf16(g, ctx.group).to(ctx.dtype), None


_a2a_wire = _A2AWire.apply


# --------------------------------------------------------------------------- paths


def moe_apply_a2a(
    params,
    x: torch.Tensor,           # (B, S, D)
    cfg: ModelConfig,
    ep: EPContext,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """a2a expert parallelism: experts split over ``data`` on the expert
    dim, each expert's FFN width over ``model``. Weights never move;
    tokens are routed to their experts' owners with one all-to-all and
    back with another, so there is no weight gather in the forward."""
    mesh = ep.mesh
    axes = mesh_axes(mesh)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    split = tuple(a for a in ("pod", "data", "model") if a in axes)
    n_data = axes.get("data", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp_size = int(np.prod([axes[a] for a in batch_axes])) if batch_axes else 1
    e_local = e // n_data
    f_local = cfg.d_ff // axes.get("model", 1)
    cap = _capacity((b // dp_size) * s, cfg)
    world = math.prod(axes.values())
    groups = _groups(mesh, split)
    batch = _batch_axes(mesh, batch_axes)

    def enter(t):
        return _Enter.apply(t, groups)

    e0 = mesh.get_local_rank("data") * e_local if "data" in axes else 0
    f0 = mesh.get_local_rank("model") * f_local if "model" in axes else 0
    router = enter(params["router"])
    wg = enter(params["w_gate"])[e0:e0 + e_local, :, f0:f0 + f_local] \
        if "w_gate" in params else None
    wu = enter(params["w_up"])[e0:e0 + e_local, :, f0:f0 + f_local]
    wd = enter(params["w_down"])[e0:e0 + e_local, f0:f0 + f_local]
    x_loc = _block(enter(x), batch)

    bl, sl, _ = x_loc.shape
    t = bl * sl
    x2d = x_loc.reshape(t, d).to(getattr(torch, cfg.compute_dtype))
    r = _route(x2d, router, cfg, cap)
    dest = torch.where(r.keep, r.ids * cap + r.pos, e * cap)
    send = _dispatch(x2d, dest, k, e * cap).reshape(e, cap, d)

    data_group = mesh.get_group("data") if n_data > 1 else None
    recv = _a2a_wire(send, data_group) if n_data > 1 else send
    # recv[i*e_local + le] = sender i's capacity slots for my expert le
    h = recv.reshape(n_data, e_local, cap, d).transpose(0, 1) \
        .reshape(e_local, n_data * cap, d)
    y = _experts(h, wg, wu, wd, cfg.act).to(x2d.dtype)   # partial over 'model'

    back = y.reshape(e_local, n_data, cap, d).transpose(0, 1) \
        .reshape(e, cap, d)
    if n_data > 1:
        back = _a2a_wire(back, data_group)
    weight = (r.gates.reshape(-1) * r.keep).to(x2d.dtype)
    y2d = _combine(back.reshape(e * cap, d), dest, weight, t, k)
    if "model" in axes:
        y2d = _Sum.apply(y2d, [mesh.get_group("model")], 1)

    lb, z = _aux_losses(r, cfg)
    # the mean over the batch axes: the ranks of 'model' hold equal values
    lb = _Sum.apply(lb, groups, world)
    z = _Sum.apply(z, groups, world)
    y_loc = y2d.reshape(bl, sl, d)
    y = _Gather.apply(y_loc, batch) if batch_axes else y_loc
    return y, {"lb": lb, "z": z}


def moe_apply(
    params,
    x: torch.Tensor,           # (B, S, D)
    cfg: ModelConfig,
    ep: EPContext = EPContext(),
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (output, {'lb': load-balance loss, 'z': router z loss})."""
    b, s, d = x.shape
    axes = mesh_axes(ep.mesh) if ep.mesh is not None else {}

    if (
        cfg.moe_layout == "a2a"
        and ep.mesh is not None
        and cfg.num_experts % max(axes.get("data", 1), 1) == 0
        and cfg.d_ff % max(axes.get("model", 1), 1) == 0
    ):
        y, aux = moe_apply_a2a(params, x, cfg, ep)
        if cfg.moe_dense_residual and "dense" in params:
            y = y + mlp_apply(params["dense"], x, cfg.act)
        return y, aux

    if ep.mesh is None or ep.ep_axis not in axes:
        x2d = x.reshape(b * s, d)
        cap = _capacity(b * s, cfg)
        y2d, lb, z = _route_and_compute(x2d, params, cfg, 0,
                                        cfg.num_experts, cap)
        y = y2d.reshape(b, s, d)
    else:
        mesh = ep.mesh
        ep_size = axes[ep.ep_axis]
        assert cfg.num_experts % ep_size == 0, (cfg.num_experts, ep_size)
        e_local = cfg.num_experts // ep_size
        dp = tuple(a for a in ep.dp_axes if a in axes)
        dp_size = int(np.prod([axes[a] for a in dp])) if dp else 1
        assert b % dp_size == 0, (b, dp_size)
        cap = _capacity((b // dp_size) * s, cfg)
        split = tuple(dict.fromkeys((*dp, ep.ep_axis)))
        groups = _groups(mesh, split)

        def enter(t):
            return _Enter.apply(t, groups)

        e0 = mesh.get_local_rank(ep.ep_axis) * e_local
        local = {n: enter(params[n])[e0:e0 + e_local]
                 for n in ("w_gate", "w_up", "w_down") if n in params}
        batch = _batch_axes(mesh, dp)
        x_loc = _block(enter(x), batch)
        bl, sl, _ = x_loc.shape
        y2d, lb, z = _route_and_compute(
            x_loc.reshape(bl * sl, d),
            {"router": enter(params["router"]), **local}, cfg, e0, e_local,
            cap)
        y_loc = _Sum.apply(y2d.reshape(bl, sl, d),
                           [mesh.get_group(ep.ep_axis)], 1)
        # the mean over dp: the ranks of the expert axis hold equal values
        n = math.prod(mesh_axes(mesh)[a] for a in split)
        lb = _Sum.apply(lb, groups, n)
        z = _Sum.apply(z, groups, n)
        y = _Gather.apply(y_loc, batch) if dp else y_loc

    if cfg.moe_dense_residual and "dense" in params:
        y = y + mlp_apply(params["dense"], x, cfg.act)
    return y, {"lb": lb, "z": z}
