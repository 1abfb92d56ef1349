"""AdamW, its schedule and the gradient transforms (counterpart of
``repro/train/optimizer.py``).

Parameters are the model's ``nn.Module`` (:class:`~repro_torch.models.
layers.ParamTree`) or any mapping of names to tensors; gradients and the
optimizer's moments are mappings keyed by the same parameter names
(``groups.0.3.attn.wq``). The arithmetic is the reference's, in its
order: the math in float32, the moments stored in ``tcfg.opt_state_dtype``,
the parameters updated in their own dtype. :func:`adamw_update` writes the
new parameters and moments into the tensors it was given, under
``torch.no_grad()``, instead of returning new ones: every value is the
reference's functional update, and a 2.6B-parameter model needs no second
copy.

The int8 gradient quantizer with error feedback (:func:`quantize_tensor`,
:func:`quantize_grads_with_feedback`, :func:`dequantize_grads`) is ported
here; the compressed cross-pod step of ``train_step.make_train_step``
uses it on a mesh of more than one pod.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..compat import all_reduce
from ..configs.base import TrainConfig

Params = Any


class OptState(NamedTuple):
    step: torch.Tensor            # int32, 0-d, on the parameters' device
    mu: dict
    nu: dict
    residual: dict | None         # error-feedback residuals (compression only)


def named(params) -> dict[str, torch.Tensor]:
    """A model's parameters (or a mapping of them) by name."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def lr_schedule(tcfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up, then a cosine from the peak to a tenth of it."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - tcfg.warmup_steps)
            / max(tcfg.total_steps - tcfg.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)

    return lr


def adamw_init(params: Params, tcfg: TrainConfig) -> OptState:
    dt = _dtype(tcfg.opt_state_dtype)
    leaves = named(params)

    def zeros() -> dict:
        # a DTensor parameter's moments are DTensors of its placements
        return {k: torch.zeros_like(p, dtype=dt, requires_grad=False)
                if isinstance(p, DTensor) else
                torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in leaves.items()}

    device = next(iter(leaves.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=zeros(),
        nu=zeros(),
        residual=zeros() if tcfg.grad_compression != "none" else None,
    )


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every leaf, whole leaves for DTensors (their
    shards' sums of squares added by DTensor), as a plain tensor."""
    norm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in named(tree).values()))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def _local(t):
    """A DTensor's local shard (in place), or the tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Params, tcfg: TrainConfig
                 ) -> tuple[Params, OptState, dict]:
    """One decoupled-weight-decay Adam step. Math in float32, states stored
    in ``tcfg.opt_state_dtype``, params updated in their own dtype. The
    parameters and the moments are written in place (each gradient is
    clipped as it is used, as :func:`clip_by_global_norm` would); returns
    ``(params, new state, {"lr", "grad_norm"})``. DTensor parameters,
    gradients and moments (of one placement a leaf) are updated shard by
    shard; the norm is over whole leaves."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, tcfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tcfg)(step)
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    sdt = _dtype(tcfg.opt_state_dtype)
    for name, p in named(params).items():
        g, p = _local(grads[name]), _local(p)
        mu, nu = _local(state.mu[name]), _local(state.nu[name])
        g32 = (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        m32 = b1 * mu.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * nu.to(torch.float32) + (1 - b2) * torch.square(g32)
        del g32
        mh = m32 / c1
        vh = v32 / c2
        mu.copy_(m32.to(sdt))
        nu.copy_(v32.to(sdt))
        del m32, v32
        delta = mh / (torch.sqrt(vh) + 1e-8) + tcfg.weight_decay * p.to(torch.float32)
        del mh, vh
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    new_state = OptState(step=step, mu=state.mu, nu=state.nu,
                         residual=state.residual)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------- int8 error-feedback


def quantize_tensor(g: torch.Tensor, max_groups=()
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale float32). With
    ``max_groups`` (the groups over whose ranks ``g`` is split) the scale
    is the whole tensor's: its largest magnitude all-reduced."""
    g32 = g.to(torch.float32)
    amax = torch.max(torch.abs(g32))
    for group in max_groups:
        amax = all_reduce(amax, "max", group)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_grads_with_feedback(
    grads: Mapping[str, torch.Tensor], residual: Mapping[str, torch.Tensor],
    max_groups=()
) -> tuple[dict, dict, dict]:
    """(q by name, scale by name, new residual by name); the residual
    carries what int8 lost. ``max_groups``: as :func:`quantize_tensor`'s,
    for shards of the leaves."""
    q_tree, s_tree, r_tree = {}, {}, {}
    for k, g in grads.items():
        r = residual[k]
        g32 = g.to(torch.float32) + r.to(torch.float32)
        q, s = quantize_tensor(g32, max_groups)
        deq = q.to(torch.float32) * s
        q_tree[k], s_tree[k], r_tree[k] = q, s, (g32 - deq).to(r.dtype)
    return q_tree, s_tree, r_tree


def dequantize_grads(q_tree: Mapping[str, torch.Tensor],
                     scale_tree: Mapping[str, torch.Tensor],
                     like: Mapping[str, torch.Tensor]) -> dict:
    return {k: (q_tree[k].to(torch.float32) * scale_tree[k]).to(torch.float32)
            for k in like}
