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
``mesh_dim_names`` are taken from ``("pod", "data", "model")``. The
parameters are DTensors placed by the rules (``launch/partitioning.py``;
a plain leaf raises), and the JAX package's ``shard_map`` becomes
``local_map``: each rank gets its batch block over the batch axes and
reads its own experts from the rules' shards (the gather layout gathers
the FSDP dim over ``data`` and keeps ``experts`` over ``model``; the a2a
layout takes ``experts_dp`` over ``data`` and the FFN width over
``model`` as they lie), with collectives on ``mesh.get_group(axis)``.
The output is a DTensor laid out as its batch block (a plain ``x``, the
same on every rank, enters replicated and comes back whole). Gradients
come back through the ``local_map``'s gradient placements: ``Partial``
over the axes whose ranks each hold a share of an input's gradient (the
expert axis for ``x``, the batch axes for the experts, every split axis
for the router), which DTensor adds up; the aux losses, equal on the
ranks of the expert or model axis, enter that sum once through
:class:`~repro_torch.compat.SumOver`'s divisor.

Aux losses (load balance and router z) are computed from the full router
distribution and averaged over the batch axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..compat import SumOver, mesh_axes
from ..configs.base import ModelConfig
from ..spans import span
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
    # the per-expert counts (bincount's), with a shape fixed ahead of the data
    counts = torch.zeros(e, dtype=torch.int64, device=r.ids.device) \
        .scatter_add_(0, r.ids, torch.ones_like(r.ids))
    frac = counts.to(torch.float32) / r.ids.numel() * k
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
    with span("moe.route"):
        r = _route(x2d, params["router"], cfg, capacity)
    with span("moe.dispatch"):
        local_sel = (r.ids >= e_start) & (r.ids < e_start + e_local) & r.keep
        slots = e_local * capacity
        dest = torch.where(local_sel, (r.ids - e_start) * capacity + r.pos,
                           slots)
        h = _dispatch(x2d, dest, k, slots).reshape(e_local, capacity, d)
    with span("moe.experts"):
        y = _experts(h, params["w_gate"] if "w_gate" in params else None,
                     params["w_up"], params["w_down"], cfg.act)
    with span("moe.combine"):
        weight = (r.gates.reshape(-1) * local_sel).to(x2d.dtype)
        y2d = _combine(y.reshape(slots, d), dest, weight, t, k)
    with span("moe.aux"):
        lb, z = _aux_losses(r, cfg)
    return y2d, lb, z


# --------------------------------------------------------------------------- collectives


def _groups(mesh, axes) -> list:
    return [mesh.get_group(a) for a in axes]


def _a2a_bf16(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all along dim 0 in bfloat16, through the functional
    collective."""
    send = x.to(torch.bfloat16).contiguous()
    n = group.size()
    out = torch.ops._c10d_functional.all_to_all_single(
        send, [send.shape[0] // n] * n, [send.shape[0] // n] * n,
        group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


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


def _placements(mesh, **by_axis) -> tuple:
    """One placement a mesh dim: ``by_axis[name]`` for the named axes,
    ``Replicate()`` elsewhere."""
    return tuple(by_axis.get(name, Replicate())
                 for name in mesh.mesh_dim_names)


def _sharded(params, names) -> None:
    for n in names:
        if n in params and not isinstance(params[n], DTensor):
            raise TypeError(
                f"moe: the expert-parallel paths take the parameters as "
                f"DTensors placed by the rules; {n!r} is a plain tensor")


def _as_dtensor(x: torch.Tensor, mesh):
    """``(DTensor, plain)``: ``x`` as it is, or a plain ``x`` (the same on
    every rank) as a replicated DTensor."""
    if isinstance(x, DTensor):
        return x, False
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False), True


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
    back with another, so there is no weight gather in the forward. A
    ``local_map`` (the reference's ``shard_map``) hands each rank its
    batch block over ``("pod", "data")`` and the expert weights in the
    rules' own placements."""
    mesh = ep.mesh
    axes = mesh_axes(mesh)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    split = tuple(a for a in ("pod", "data", "model") if a in axes)
    n_data = axes.get("data", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp_size = int(np.prod([axes[a] for a in batch_axes])) if batch_axes else 1
    e_local = e // n_data
    cap = _capacity((b // dp_size) * s, cfg)
    world = math.prod(axes.values())
    groups = _groups(mesh, split)
    data_group = mesh.get_group("data") if n_data > 1 else None
    model_group = mesh.get_group("model") if "model" in axes else None
    cdtype = getattr(torch, cfg.compute_dtype)

    def local_fn(x_loc, router, wg, wu, wd):
        bl, sl, _ = x_loc.shape
        t = bl * sl
        x2d = x_loc.reshape(t, d).to(cdtype)
        with span("moe.route"):
            r = _route(x2d, router, cfg, cap)
        with span("moe.dispatch"):
            dest = torch.where(r.keep, r.ids * cap + r.pos, e * cap)
            send = _dispatch(x2d, dest, k, e * cap).reshape(e, cap, d)
        recv = send
        if n_data > 1:
            with span("moe.all_to_all"):
                recv = _a2a_wire(send, data_group)
        # recv[i*e_local + le] = sender i's capacity slots for my expert le
        h = recv.reshape(n_data, e_local, cap, d).transpose(0, 1) \
            .reshape(e_local, n_data * cap, d)
        # partial over 'model'
        with span("moe.experts"):
            y = _experts(h, wg, wu, wd, cfg.act).to(x2d.dtype)
        back = y.reshape(e_local, n_data, cap, d).transpose(0, 1) \
            .reshape(e, cap, d)
        if n_data > 1:
            with span("moe.all_to_all"):
                back = _a2a_wire(back, data_group)
        with span("moe.combine"):
            weight = (r.gates.reshape(-1) * r.keep).to(x2d.dtype)
            y2d = _combine(back.reshape(e * cap, d), dest, weight, t, k)
            if model_group is not None:
                y2d = SumOver.apply(y2d, [model_group], 1)
        with span("moe.aux"):
            lb, z = _aux_losses(r, cfg)
        # the mean over the batch axes: the ranks of 'model' hold equal values
        lb = SumOver.apply(lb, groups, world)
        z = SumOver.apply(z, groups, world)
        return y2d.reshape(bl, sl, d), lb, z

    names = ("w_gate", "w_up", "w_down")
    _sharded(params, ("router", *names))
    x, plain = _as_dtensor(x, mesh)
    batch = {a: Shard(0) for a in batch_axes}
    rep = _placements(mesh)
    part = {a: Partial() for a in split}
    w_in = {n: tuple(params[n].placements) for n in names if n in params}
    w_grad = {n: tuple(Partial() if name == "pod" else p for name, p in
                       zip(mesh.mesh_dim_names, pl))
              for n, pl in w_in.items()}
    ws = [params[n] if n in params else None for n in names]
    y, lb, z = local_map(
        local_fn,
        out_placements=(_placements(mesh, **batch), rep, rep),
        in_placements=(_placements(mesh, **batch), rep,
                       *(w_in.get(n) for n in names)),
        in_grad_placements=(
            _placements(mesh, **batch, **({"model": Partial()}
                                          if "model" in axes else {})),
            _placements(mesh, **part), *(w_grad.get(n) for n in names)),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, params["router"], *ws)
    if plain:
        y, lb, z = (t.full_tensor() for t in (y, lb, z))
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
        cap = _capacity(b * s, cfg)
        names = tuple(n for n in ("router", "w_gate", "w_up", "w_down")
                      if n in params)

        def local_fn(x, *ws):
            y2d, lb, z = _route_and_compute(
                x.reshape(b * s, d), dict(zip(names, ws)), cfg, 0,
                cfg.num_experts, cap)
            return y2d.reshape(b, s, d), lb, z

        if isinstance(x, DTensor):
            # the whole expert set on every rank, over the whole batch
            rep = _placements(x.device_mesh)
            local_fn = local_map(
                local_fn, out_placements=(rep, rep, rep),
                in_placements=(rep,) * (1 + len(names)),
                device_mesh=x.device_mesh, redistribute_inputs=True)
        y, lb, z = local_fn(x, *(params[n] for n in names))
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
        n = math.prod(axes[a] for a in split)
        ep_group = mesh.get_group(ep.ep_axis)
        e0 = mesh.get_local_rank(ep.ep_axis) * e_local
        names = tuple(w for w in ("w_gate", "w_up", "w_down") if w in params)

        def local_fn(x_loc, router, *ws):
            bl, sl, _ = x_loc.shape
            y2d, lb, z = _route_and_compute(
                x_loc.reshape(bl * sl, d),
                {"router": router, **dict(zip(names, ws))}, cfg, e0,
                e_local, cap)
            y_loc = SumOver.apply(y2d.reshape(bl, sl, d), [ep_group], 1)
            # the mean over dp: the ranks of the expert axis hold equal values
            return (y_loc, SumOver.apply(lb, groups, n),
                    SumOver.apply(z, groups, n))

        _sharded(params, ("router", *names))
        x_in, plain = _as_dtensor(x, mesh)
        batch = {a: Shard(0) for a in dp}
        rep = _placements(mesh)
        experts = _placements(mesh, **{ep.ep_axis: Shard(0)})
        y, lb, z = local_map(
            local_fn,
            out_placements=(_placements(mesh, **batch), rep, rep),
            in_placements=(_placements(mesh, **batch), rep,
                           *(experts for _ in names)),
            in_grad_placements=(
                _placements(mesh, **batch, **{ep.ep_axis: Partial()}),
                _placements(mesh, **{a: Partial() for a in split}),
                *(_placements(mesh, **{a: Partial() for a in dp},
                              **{ep.ep_axis: Shard(0)}) for _ in names)),
            device_mesh=mesh, redistribute_inputs=True,
        )(x_in, params["router"], *(params[w] for w in names))
        if plain:
            y, lb, z = (t.full_tensor() for t in (y, lb, z))

    if cfg.moe_dense_residual and "dense" in params:
        y = y + mlp_apply(params["dense"], x, cfg.act)
    return y, {"lb": lb, "z": z}
