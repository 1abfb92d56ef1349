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

The reference's compressed cross-pod step (an int8 all-gather of the
gradients under ``shard_map`` over a pod axis) runs only on a mesh with
more than one pod; on one card the reference itself takes the plain step.
The port has no mesh yet (``ROADMAP.md`` queue 1 item 3): asking for one
raises. Its quantizer is ported in :mod:`.optimizer`.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import TrainConfig
from ..models.model import ModelBundle
from . import optimizer as opt

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


def make_train_step(
    bundle: ModelBundle,
    tcfg: TrainConfig,
    mesh=None,
    pod_axis: Optional[str] = None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``. A mesh or a
    pod axis raises: the compressed cross-pod step waits for the mesh."""
    if mesh is not None or pod_axis is not None:
        raise NotImplementedError(
            "not ported yet: a mesh and the compressed cross-pod step wait "
            "for ROADMAP.md queue 1 item 3")

    def train_step(state: TrainState, batch: dict):
        grads, metrics = _grads_and_metrics(bundle, tcfg, state.params, batch)
        params, ostate, ometrics = opt.adamw_update(
            grads, state.opt, state.params, tcfg)
        return TrainState(params, ostate), {**metrics, **ometrics}

    return train_step


def make_eval_step(bundle: ModelBundle):
    @torch.no_grad()
    def eval_step(params: Params, batch: dict):
        _, metrics = bundle.loss_fn(params, batch)
        return metrics

    return eval_step
