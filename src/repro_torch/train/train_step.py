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
``("pod", "data", "model")``) every rank holds the full parameters and
moments and takes its block of the global batch over ``("pod",
"data")``; the gradients and the metrics are averaged over those axes
(a SUM all-reduce divided by the count, which gloo allows). The
reference's loss is a mean over equal slices, so the mean of the ranks'
means is its global mean. Ranks along ``model`` compute the same step.

The compressed step runs when ``tcfg.grad_compression == "int8"`` and the
mesh's ``pod_axis`` has more than one rank, as the reference's: the
gradients are averaged within the pod (over ``data``), quantized to int8
with error feedback, one scale a leaf of the reference's tree (the layers
of a stacked leaf share it; the residual carried in ``OptState.residual``),
all-gathered over the pod group as int8 values and float32 scales, and
averaged as the reference's ``einsum("p...,p->...") / npods``
(:func:`cross_pod_mean`); the metrics are averaged over the pod. A pod
axis of one rank takes the plain step. ``grad_shardings=`` (the
reference's layout pin for XLA's reduce-scatter) waits for the dry-run
slice (``ROADMAP.md`` queue 1 item 3) and raises.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..compat import mesh_axes
from ..configs.base import TrainConfig
from ..launch.mesh import batch_axes
from ..models.model import ModelBundle
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
    # every batch entry is batch-leading (tokens, targets, src_embeds)
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        mb = x.shape[0] // k
        out[key] = x[i * mb:(i + 1) * mb]
    return out


def _grads_and_metrics(bundle: ModelBundle, tcfg: TrainConfig,
                       params: Params, batch: dict) -> tuple[dict, dict]:
    """Plain or accumulated gradients (float32 accumulator) by parameter
    name, and the (last microbatch's) metrics."""
    leaves = opt.named(params)
    names, tensors = list(leaves), list(leaves.values())
    k = tcfg.microbatches
    if k <= 1:
        loss, metrics = bundle.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tensors)
        return dict(zip(names, grads)), _detached(metrics)
    acc = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for n, t in leaves.items()}
    metrics = {}
    for i in range(k):
        loss, metrics = bundle.loss_fn(params, _slice(batch, i, k))
        grads = torch.autograd.grad(loss, tensors)
        for n, g in zip(names, grads):
            acc[n] += g.to(torch.float32)
        del grads, loss
    for g in acc.values():
        g /= k
    return acc, _detached(metrics)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _batch_block(batch: dict, index: int, count: int) -> dict:
    """Block ``index`` of ``count`` of every batch entry along its batch
    dim (dim 1 of mrope's (3, B, S) positions, else dim 0)."""
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        dim = 1 if key == "positions" and x.dim() == 3 else 0
        if x.shape[dim] % count:
            raise ValueError(f"batch entry {key!r} of {x.shape[dim]} rows "
                             f"does not split into {count} equal blocks")
        out[key] = x.chunk(count, dim=dim)[index] if count > 1 else x
    return out


def _mean_over(tensors, groups: list, count: int) -> None:
    """Each tensor in place: the sum over ``groups`` in turn, over
    ``count``."""
    for t in tensors:
        for group in groups:
            dist.all_reduce(t, group=group)
        if count > 1:
            t /= count


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


def compressed_pod_mean(grads: dict, residual: dict, group, npods: int) -> dict:
    """The cross-pod mean of ``grads`` in int8 with error feedback, the
    residual written in place. The reference quantizes each leaf of its
    tree with one scale, and a stacked leaf holds every layer of a group,
    so the port's per-layer gradients are stacked back into the
    reference's leaves, one leaf at a time, for the quantizer and the
    gather, and the mean is handed back a layer at a time."""
    leaves: dict[str, list[str]] = {}
    for name in grads:
        leaves.setdefault(reference_key(name), []).append(name)
    out = {}
    for key, names in leaves.items():
        g = {key: torch.stack([grads[n] for n in names])}
        r = {key: torch.stack([residual[n] for n in names])}
        q, scales, resid = opt.quantize_grads_with_feedback(g, r)
        mean = cross_pod_mean(q, scales, group, npods)[key]
        for i, n in enumerate(names):
            residual[n].copy_(resid[key][i])
            out[n] = mean[i]
    return out


def make_train_step(
    bundle: ModelBundle,
    tcfg: TrainConfig,
    mesh=None,
    pod_axis: Optional[str] = None,
    grad_shardings=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the plain
    step, the step on ``mesh``, or on a mesh whose ``pod_axis`` has more
    than one rank with ``tcfg.grad_compression == "int8"``, the compressed
    cross-pod step. Every rank is handed the same global batch."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings: the layout pin waits for the dry-run slice "
            "(ROADMAP.md queue 1 item 3)")

    def plain_step(state: TrainState, batch: dict):
        grads, metrics = _grads_and_metrics(bundle, tcfg, state.params, batch)
        params, ostate, ometrics = opt.adamw_update(
            grads, state.opt, state.params, tcfg)
        return TrainState(params, ostate), {**metrics, **ometrics}

    if mesh is None:
        return plain_step

    axes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in baxes:
        index = index * axes[a] + coord[a]
    blocks = math.prod(axes[a] for a in baxes)
    compress = (tcfg.grad_compression == "int8" and pod_axis is not None
                and axes.get(pod_axis, 1) > 1)
    inner = [a for a in baxes if a != pod_axis] if compress else baxes
    inner_groups = [mesh.get_group(a) for a in inner]
    inner_count = math.prod(axes[a] for a in inner)

    def mesh_step(state: TrainState, batch: dict):
        grads, metrics = _grads_and_metrics(
            bundle, tcfg, state.params, _batch_block(batch, index, blocks))
        _mean_over(grads.values(), inner_groups, inner_count)
        if compress:
            grads = compressed_pod_mean(grads, state.opt.residual,
                                     mesh.get_group(pod_axis), axes[pod_axis])
        params, ostate, ometrics = opt.adamw_update(
            grads, state.opt, state.params, tcfg)
        metrics = {k: v.to(torch.float32).clone()
                   for k, v in {**metrics, **ometrics}.items()}
        groups = inner_groups + ([mesh.get_group(pod_axis)] if compress
                                 else [])
        _mean_over(metrics.values(), groups, blocks)
        return TrainState(params, ostate), metrics

    return mesh_step


def make_eval_step(bundle: ModelBundle):
    @torch.no_grad()
    def eval_step(params: Params, batch: dict):
        _, metrics = bundle.loss_fn(params, batch)
        return metrics

    return eval_step
