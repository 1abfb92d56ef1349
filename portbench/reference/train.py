"""Plain PyTorch reference of a training job's first steps: the loss and
its gradients in float32 by autograd (:func:`portbench.reference.
transformer.loss`), a microbatch at a time and averaged, then AdamW as
the job's configuration states it.

The job states the storage, and the reference keeps it: parameters held
in the configuration's ``param_dtype`` and read as float32 each step,
AdamW's moments stored in ``opt_state_dtype``, its arithmetic in float32
(the gradients clipped to the global norm ``grad_clip``, a linear warm-up
then a cosine to a tenth of the peak, decoupled weight decay on every
leaf, the update from the unrounded moments).

Returns, for the comparison: each step's loss of its last microbatch (as
the program reports it), each leaf's first gradient as the optimizer
took it (its stored first moment over ``1 - beta1``), and each leaf's
change over the steps.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from . import transformer as tf


def learning_rate(step: int, tc: dict) -> float:
    warm = min(step / max(tc["warmup_steps"], 1), 1.0)
    prog = min(max((step - tc["warmup_steps"])
                   / max(tc["total_steps"] - tc["warmup_steps"], 1), 0.0), 1.0)
    return tc["learning_rate"] * warm * (
        0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def first_steps(source: Callable[[str], torch.Tensor], cfg: dict, tc: dict,
                batches: list[dict], precision: str = "float32",
                chunk_rows: int = 0) -> dict:
    """``losses``, ``grad_norms`` and ``update_norms`` (by leaf) of the
    first ``len(batches)`` steps from the weights ``source`` gives. Each
    microbatch runs ``chunk_rows`` rows at a time (all at once with 0),
    its loss and gradient the mean of its chunks' (equal chunks: the same
    mean), so that float32 activations fit beside the program's
    batch."""
    arith = tf.Arith(precision)
    shapes = tf.parameter_shapes(cfg)
    pdt = getattr(torch, cfg["param_dtype"])
    sdt = getattr(torch, tc["opt_state_dtype"])
    b1, b2 = tc["beta1"], tc["beta2"]
    k = tc["microbatches"]
    stored = {n: source(n).to(pdt) for n in shapes}
    mu = {n: torch.zeros_like(t, dtype=sdt) for n, t in stored.items()}
    nu = {n: torch.zeros_like(t, dtype=sdt) for n, t in stored.items()}
    losses, grad_norms = [], {}
    with tf.strict_float32():
        for number, batch in enumerate(batches, 1):
            p32 = {n: t.to(torch.float32).requires_grad_(True)
                   for n, t in stored.items()}
            rows = batch["tokens"].shape[0] // k
            chunk = chunk_rows or rows
            if rows % chunk:
                raise ValueError(f"{rows} rows a microbatch, chunks of {chunk}")
            for i in range(k):
                last = 0.0
                for j in range(i * rows, (i + 1) * rows, chunk):
                    part = {key: v[j:j + chunk] for key, v in batch.items()}
                    loss = tf.loss(p32.__getitem__, part, cfg, arith) \
                        * (chunk / rows)
                    loss.backward()
                    last += float(loss.detach())
                    del loss
            losses.append(last)
            with torch.no_grad():
                grads = {n: p.grad / k for n, p in p32.items()}
                del p32
                norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
                scale = torch.clamp(tc["grad_clip"] / torch.clamp(norm, min=1e-9),
                                    max=1.0)
                lr = learning_rate(number, tc)
                c1, c2 = 1.0 - b1 ** number, 1.0 - b2 ** number
                for n, g in grads.items():
                    g = g * scale
                    m = b1 * mu[n].to(torch.float32) + (1 - b1) * g
                    v = b2 * nu[n].to(torch.float32) + (1 - b2) * g.square()
                    mu[n] = m.to(sdt)
                    nu[n] = v.to(sdt)
                    p = stored[n].to(torch.float32)
                    delta = (m / c1) / (torch.sqrt(v / c2) + 1e-8) \
                        + tc["weight_decay"] * p
                    stored[n] = (p - lr * delta).to(pdt)
                del grads
                if number == 1:
                    grad_norms = {n: float(t.to(torch.float32).norm() / (1 - b1))
                                  for n, t in mu.items()}
    update_norms = {n: float((t.to(torch.float32)
                              - source(n).to(torch.float32)).norm())
                    for n, t in stored.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms}
