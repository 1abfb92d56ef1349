"""train_step: loss -> grads -> AdamW (counterpart of
``repro/train/train_step.py``).

Microbatch gradient accumulation is a loop over batch slices with a
float32 gradient accumulator, divided by the count at the end, where the
reference runs a ``lax.scan``; the metrics are the last microbatch's, as
the scan's carry leaves them. Gradients come from ``torch.autograd.grad``
on the bundle's ``loss_fn``, through the kernels' ``autograd.Function`` s.
The update is written into the state's tensors in place
(:func:`~repro_torch.train.optimizer.adamw_update`); the step returns the
same ``TrainState`` tensors, updated.

On a mesh (``make_train_step(..., mesh=)``, a ``DeviceMesh`` over
``("pod", "data", "model")``) the state is in the rules' layout
(:func:`shard_train_state`): every parameter, both moments and the int8
residual are DTensors placed by ``Partitioner(mesh).tree_shardings(
bundle.abstract(), bundle.axes)`` (FSDP over ``data`` on ``embed``,
tensor parallelism over ``model``), and the batch is ``Shard(0)`` over
``("pod", "data")`` (a plain batch, the same on every rank, becomes each
rank's block). The loss runs under ``set_mesh`` on those DTensors, with
DTensor's sharding propagation in the part of GSPMD, and each gradient is
redistributed to its parameter's placements as it leaves autograd (out
of ``Partial``: a reduce-scatter), or to ``grad_shardings=`` (the
reference's pin, a tree of shardings in the reference's layout). The
update runs on each rank's shards; the clipping norm is over whole
leaves. The loss is the global mean, so the gradients are the reference's.

The compressed step runs when ``tcfg.grad_compression == "int8"`` and the
mesh's ``pod_axis`` has more than one rank, as the reference's: the
gradients are reduced within the pod only (they stay ``Partial`` over the
pod; times the pod count, each is its pod's mean), quantized to int8
with error feedback, one scale a leaf of the reference's tree (the layers
of a stacked leaf share it, and so do its shards: the scale is the
all-reduced maximum over the whole leaf; the residual carried in
``OptState.residual``), all-gathered over the pod group as int8 shards
and float32 scales, and averaged as the reference's ``einsum("p...,p->...")
/ npods`` (:func:`cross_pod_mean`). A pod axis of one rank takes the
plain mesh step.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..compat import mesh_axes, set_mesh
from ..configs.base import TrainConfig
from ..launch.mesh import batch_axes
from ..launch.partitioning import (
    param_shardings, placements_of, shard_module, shard_tensor,
)
from ..models.layers import ParamTree
from ..models.model import ModelBundle
from ..models.transformer import layer_specs
from ..spans import span
from . import optimizer as opt
from .checkpoint import reference_key

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: opt.OptState

    @property
    def step(self) -> torch.Tensor:
        return self.opt.step


def init_train_state(bundle: ModelBundle, tcfg: TrainConfig,
                     generator: torch.Generator) -> TrainState:
    """Trainable parameters drawn from ``generator`` (a generator of the
    bundle's device) and a fresh AdamW state."""
    params = bundle.init(generator, trainable=True)
    return TrainState(params=params, opt=opt.adamw_init(params, tcfg))


def _slice(batch: dict, i: int, k: int) -> dict:
    """Microbatch ``i`` of ``k``: every batch entry is batch-leading
    (tokens, targets, src_embeds); a DTensor entry is sliced on each
    rank's own block, so that the slice keeps its layout."""
    out = {}
    for key, x in batch.items():
        if isinstance(x, DTensor):
            loc = x.to_local()
            mb = loc.shape[0] // k
            out[key] = DTensor.from_local(loc[i * mb:(i + 1) * mb],
                                          x.device_mesh, x.placements,
                                          run_check=False)
            continue
        x = torch.as_tensor(x)
        mb = x.shape[0] // k
        out[key] = x[i * mb:(i + 1) * mb]
    return out


def _grads_and_metrics(bundle: ModelBundle, tcfg: TrainConfig,
                       params: Params, batch: dict,
                       placements: Optional[dict] = None
                       ) -> tuple[dict, dict]:
    """Plain or accumulated gradients (float32 accumulator) by parameter
    name, and the (last microbatch's) metrics. With ``placements`` (name
    -> DTensor placements) each DTensor gradient is redistributed to its
    entry as it comes out of autograd: out of ``Partial`` that is a
    reduce-scatter (the reference's ``grad_shardings`` pin)."""
    leaves = opt.named(params)
    names, tensors = list(leaves), list(leaves.values())

    def grad(loss):
        # the recomputation of remat runs in here: plain constants (RoPE's
        # frequencies) meet DTensors again
        with span("train.backward"), implicit_replication():
            return torch.autograd.grad(loss, tensors)

    def pinned(grads):
        if placements is None:
            return grads
        return [g.redistribute(g.device_mesh, placements[n])
                if isinstance(g, DTensor) else g
                for n, g in zip(names, grads)]

    def forward(batch):
        with span("train.forward"):
            return bundle.loss_fn(params, batch)

    k = tcfg.microbatches
    if k <= 1:
        loss, metrics = forward(batch)
        grads = pinned(grad(loss))
        return dict(zip(names, grads)), _detached(metrics)
    acc = None
    metrics = {}
    for i in range(k):
        loss, metrics = forward(_slice(batch, i, k))
        grads = pinned(grad(loss))
        with span("train.accumulate"):
            if acc is None:
                acc = {n: torch.zeros_like(g, dtype=torch.float32)
                       for n, g in zip(names, grads)}
            for n, g in zip(names, grads):
                acc[n] += g.to(torch.float32)
        del grads, loss
    with span("train.accumulate"):
        for g in acc.values():
            g /= k
    return acc, _detached(metrics)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain float32 tensor (a DTensor's full value)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.to(torch.float32).clone()


def _batch_block(batch: dict, mesh, axes: tuple) -> dict:
    """Every batch entry as a DTensor sharded on its batch dim (dim 1 of
    mrope's (3, B, S) positions, else dim 0) over the mesh's ``axes``,
    replicated elsewhere: a plain entry (the same global batch on every
    rank) becomes this rank's block with no collective; a DTensor entry
    is redistributed to that layout."""
    out = {}
    for key, x in batch.items():
        dim = 1 if key == "positions" and x.dim() == 3 else 0
        spec = [None] * x.dim()
        spec[dim] = axes if axes else None
        sharding = placements_of(mesh, tuple(spec))
        if isinstance(x, DTensor):
            out[key] = x.redistribute(mesh, sharding.placements)
            continue
        x = torch.as_tensor(x)
        count = math.prod(mesh_axes(mesh)[a] for a in axes)
        if x.shape[dim] % count:
            raise ValueError(f"batch entry {key!r} of {x.shape[dim]} rows "
                             f"does not split into {count} equal blocks")
        out[key] = shard_tensor(x, sharding)
    return out


def cross_pod_mean(q: dict, scales: dict, group, npods: int) -> dict:
    """The reference's cross-pod mean of int8 gradients: every pod's
    values (int8) and scales (float32) all-gathered over ``group``, then
    ``einsum("p...,p->...", values, scales) / npods`` by name."""
    out = {}
    for name, qt in q.items():
        qg = torch.empty(npods * qt.numel(), dtype=qt.dtype, device=qt.device)
        dist.all_gather_into_tensor(qg, qt.reshape(-1), group=group)
        sg = torch.empty((npods,), dtype=torch.float32, device=qt.device)
        dist.all_gather_into_tensor(sg, scales[name].reshape(1), group=group)
        out[name] = torch.einsum("p...,p->...",
                                 qg.view(npods, *qt.shape).to(torch.float32),
                                 sg) / npods
    return out


def compressed_pod_mean(grads: dict, residual: dict, group, npods: int,
                        max_groups: Optional[dict] = None) -> dict:
    """The cross-pod mean of ``grads`` in int8 with error feedback, the
    residual written in place. The reference quantizes each leaf of its
    tree with one scale, and a stacked leaf holds every layer of a group,
    so the port's per-layer gradients are stacked back into the
    reference's leaves, one leaf at a time, for the quantizer and the
    gather, and the mean is handed back a layer at a time. On a mesh the
    tensors are each rank's shards and ``max_groups`` (name -> the groups
    over which the leaf is split within its pod) makes each leaf's scale
    the one over the whole leaf, as GSPMD computes it."""
    leaves: dict[str, list[str]] = {}
    for name in grads:
        leaves.setdefault(reference_key(name), []).append(name)
    out = {}
    for key, names in leaves.items():
        g = {key: torch.stack([grads[n] for n in names])}
        r = {key: torch.stack([residual[n] for n in names])}
        groups = (max_groups or {}).get(names[0], ())
        q, scales, resid = opt.quantize_grads_with_feedback(
            g, r, max_groups=groups)
        mean = cross_pod_mean(q, scales, group, npods)[key]
        for i, n in enumerate(names):
            residual[n].copy_(resid[key][i])
            out[n] = mean[i]
    return out


def shard_train_state(state: TrainState, bundle: ModelBundle, mesh
                      ) -> TrainState:
    """``state`` (the same full tensors on every rank) in the rules'
    layout on ``mesh``: a parameter module of DTensors holding this rank's
    shards (``partitioning.shard_module``), and each moment and residual a
    DTensor of the same placements (no collective: every rank slices its
    own)."""
    shardings = param_shardings(bundle, mesh)

    def shard(tree):
        return None if tree is None else {
            n: shard_tensor(t, shardings[n]) for n, t in tree.items()}

    o = state.opt
    return TrainState(shard_module(state.params, bundle, mesh, shardings),
                      opt.OptState(step=o.step, mu=shard(o.mu),
                                   nu=shard(o.nu),
                                   residual=shard(o.residual)))


def _in_step_span(step):
    """``step`` run inside the ``train.step`` span."""

    @functools.wraps(step)
    def train_step(state: TrainState, batch: dict):
        with span("train.step"):
            return step(state, batch)

    return train_step


def make_train_step(
    bundle: ModelBundle,
    tcfg: TrainConfig,
    mesh=None,
    pod_axis: Optional[str] = None,
    grad_shardings=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the plain
    step, the step on ``mesh`` (the state in the rules' layout,
    :func:`shard_train_state`), or on a mesh whose ``pod_axis`` has more
    than one rank with ``tcfg.grad_compression == "int8"``, the compressed
    cross-pod step. ``grad_shardings`` (a tree of :class:`~repro_torch.
    launch.partitioning.Sharding` in the reference's layout, as
    ``Partitioner.tree_shardings`` gives it) says where each gradient goes
    as it leaves autograd; by default each parameter's own placements."""

    def plain_step(state: TrainState, batch: dict):
        grads, metrics = _grads_and_metrics(bundle, tcfg, state.params, batch)
        with span("train.optimizer"):
            params, ostate, ometrics = opt.adamw_update(
                grads, state.opt, state.params, tcfg)
        return TrainState(params, ostate), {**metrics, **ometrics}

    if mesh is None:
        if grad_shardings is not None:
            raise ValueError("grad_shardings: the layout pin needs a mesh "
                             "(make_train_step(..., mesh=))")
        return _in_step_span(plain_step)

    axes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    compress = (tcfg.grad_compression == "int8" and pod_axis is not None
                and axes.get(pod_axis, 1) > 1)
    names = mesh.mesh_dim_names
    targets = {n: sh.placements for n, sh in param_shardings(
        bundle, mesh, grad_shardings).items()}
    if compress:
        # the reference's shard_map, manual over the pod: each pod runs the
        # loss on the mesh of its own ranks, so that its gradients are its
        # own mean; the rules never shard a parameter over the pod
        pod = names.index(pod_axis)
        npods = axes[pod_axis]
        inner = tuple(n for n in names if n != pod_axis)
        sub = mesh[inner]
        sub_targets = {n: tuple(p for m, p in enumerate(pl) if m != pod)
                       for n, pl in targets.items()}
        max_groups = {n: tuple(mesh.get_group(m) for m, p in enumerate(pl)
                               if isinstance(p, Shard))
                      for n, pl in targets.items()}
        pod_group = mesh.get_group(pod_axis)
        pod_batch = tuple(a for a in baxes if a != pod_axis)

    def check(state):
        leaves = opt.named(state.params)
        plain = [n for n, p in leaves.items() if not isinstance(p, DTensor)]
        if plain:
            raise TypeError(
                f"the mesh step takes the state in the rules' layout "
                f"(shard_train_state); {plain[0]!r} is a plain tensor")
        return leaves

    def mesh_step(state: TrainState, batch: dict):
        check(state)
        with set_mesh(mesh):
            grads, metrics = _grads_and_metrics(
                bundle, tcfg, state.params, _batch_block(batch, mesh, baxes),
                targets)
        with span("train.optimizer"):
            params, ostate, ometrics = opt.adamw_update(
                grads, state.opt, state.params, tcfg)
        metrics = {k: _plain(v) for k, v in {**metrics, **ometrics}.items()}
        return TrainState(params, ostate), metrics

    def compressed_step(state: TrainState, batch: dict):
        leaves = check(state)
        # this pod's parameters (the same shards) and batch block on its mesh
        mine = _on_mesh(bundle, leaves, sub, sub_targets)
        block = _batch_block(batch, mesh, baxes)
        block = {k: DTensor.from_local(
            x.to_local(), sub, [p for m, p in enumerate(x.placements)
                                if m != pod], run_check=False)
            for k, x in block.items()}
        with set_mesh(sub):
            grads, metrics = _grads_and_metrics(
                bundle, tcfg, mine, _batch_block(block, sub, pod_batch),
                sub_targets)
        with torch.no_grad():
            mean = compressed_pod_mean(
                {n: g.to_local() for n, g in grads.items()},
                {n: r.to_local() for n, r in state.opt.residual.items()},
                pod_group, npods, max_groups)
        grads = {n: DTensor.from_local(mean[n], mesh, leaves[n].placements,
                                       run_check=False, shape=leaves[n].shape,
                                       stride=leaves[n].stride())
                 for n in grads}
        with span("train.optimizer"):
            params, ostate, ometrics = opt.adamw_update(
                grads, state.opt, state.params, tcfg)
        metrics = {k: _plain(v) for k, v in metrics.items()}
        for v in metrics.values():          # the mean over the pods
            dist.all_reduce(v, group=pod_group)
            v /= npods
        metrics.update({k: _plain(v) for k, v in ometrics.items()})
        return TrainState(params, ostate), metrics

    return _in_step_span(compressed_step if compress else mesh_step)


def _on_mesh(bundle: ModelBundle, leaves: dict, mesh, placements: dict):
    """A parameter module whose parameters are DTensors on ``mesh`` (a
    sub-mesh) over the same local shards as ``leaves``, new leaves of
    autograd."""
    module = ParamTree(layer_specs(bundle.cfg),
                       getattr(torch, bundle.cfg.param_dtype), "meta",
                       trainable=True)
    for name, p in leaves.items():
        *path, leaf = name.split(".")
        module.get_submodule(".".join(path))._parameters[leaf] = \
            torch.nn.Parameter(DTensor.from_local(
                p.to_local().detach(), mesh, list(placements[name]),
                run_check=False, shape=p.shape, stride=p.stride()),
                requires_grad=True)
    return module


def make_eval_step(bundle: ModelBundle):
    @torch.no_grad()
    def eval_step(params: Params, batch: dict):
        _, metrics = bundle.loss_fn(params, batch)
        return metrics

    return eval_step
