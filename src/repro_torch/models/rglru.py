"""RG-LRU recurrent block, Griffin / RecurrentGemma (counterpart of
``repro/models/rglru.py``).

Temporal mixing: linear branch -> short causal depthwise conv -> RG-LRU
gated linear recurrence, multiplied by a GeLU gate branch, projected back.
The recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(c * r_t * log(sigmoid(lambda)))        (c = 8)

runs over a sequence as :func:`repro_torch.kernels.rglru.ops.rglru_scan`:
kernel K6 on the card, its sequential plain version on the CPU (the JAX
package runs it as an associative scan, the same recurrence in another
order of rounding). Decode carries ``(h, conv tail)`` as state and runs
one step in plain torch, as the reference does.

Gates (r, i) are per-channel (diagonal) sigmoid gates on the conv output.
Activations are the reference's: ``jax.nn.gelu(approximate=True)`` is
``F.gelu(approximate="tanh")``, ``jax.nn.log_sigmoid`` is
``F.logsigmoid``. The state is stored in the input's dtype, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ..configs.base import ModelConfig
from ..kernels.rglru.ops import rglru_scan
from .layers import EMBED, LRU, ParamSpec

C_FACTOR = 8.0


def rglru_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, w = cfg.d_model, cfg.resolved_lru_width
    return {
        "w_x": ParamSpec((d, w), (EMBED, LRU)),
        "w_gate": ParamSpec((d, w), (EMBED, LRU)),
        "w_out": ParamSpec((w, d), (LRU, EMBED)),
        "conv": ParamSpec((cfg.conv_width, w), (None, LRU), init="small"),
        "a_diag": ParamSpec((w,), (LRU,), init="ones"),
        "a_bias": ParamSpec((w,), (LRU,), init="zeros"),
        "i_diag": ParamSpec((w,), (LRU,), init="ones"),
        "i_bias": ParamSpec((w,), (LRU,), init="zeros"),
        "lam": ParamSpec((w,), (LRU,), init="ones", scale=4.0),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  tail: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C). Returns (y,
    new_tail), the tail being the last W-1 inputs (the decode carry). The
    tail is a copy, not a view: a view would keep the whole padded input of
    a prefill alive in the cache."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i][None, None, :] for i in range(width))
    new_tail = xp[:, -(width - 1):].clone() if width > 1 else tail
    return y, new_tail


def _pointwise(n_in: int, n_out: int):
    """A DTensor sharding rule for an elementwise op of ``n_in`` tensor
    operands and ``n_out`` outputs, all of one shape: replicated, or all
    sharded alike on any dim."""
    def rule(x, *args):
        return [([p] * n_out, [p] * n_in)
                for p in [Replicate()] + [Shard(d) for d in range(x.ndim)]]
    return rule


# DTensor has no strategy for log-sigmoid (F.logsigmoid): elementwise
register_sharding(torch.ops.aten.log_sigmoid_forward.default)(_pointwise(1, 2))
register_sharding(torch.ops.aten.log_sigmoid_backward.default)(
    _pointwise(3, 1))


def _gates(params, u: torch.Tensor):
    """Per-channel recurrence gates; returns (log_a, b_scale) in float32."""
    f32 = torch.float32
    uf = u.to(f32)
    r = torch.sigmoid(uf * params["a_diag"].to(f32) + params["a_bias"].to(f32))
    i = torch.sigmoid(uf * params["i_diag"].to(f32) + params["i_bias"].to(f32))
    log_lam = F.logsigmoid(params["lam"].to(f32))
    log_a = C_FACTOR * r * log_lam            # <= 0
    a_sq = torch.exp(2.0 * log_a)
    b_scale = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-12)) * i
    return log_a, b_scale


def rglru_sequence(params, x: torch.Tensor, cfg: ModelConfig,
                   h0: torch.Tensor | None = None,
                   conv_tail: torch.Tensor | None = None):
    """Full-sequence RG-LRU. x: (B, S, D). Returns (y, (h_last,
    conv_tail)), h_last in x's dtype."""
    u = x @ params["w_x"]
    gate = x @ params["w_gate"]
    u, new_tail = causal_conv1d(u, params["conv"], conv_tail)
    log_a, b_scale = _gates(params, u)
    b = b_scale * u.to(torch.float32)
    a = torch.exp(log_a)
    h = rglru_scan(a, b, None if h0 is None else h0.to(torch.float32))
    y = F.gelu(gate.to(torch.float32), approximate="tanh") * h
    out = y.to(x.dtype) @ params["w_out"]
    # a copy: h[:, -1] alone would keep the whole float32 trajectory alive
    return out, (h[:, -1].to(x.dtype, copy=True), new_tail)


def rglru_step(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One decode step. x: (B, 1, D); cache {'h': (B, W), 'conv': (B,
    cw-1, W)}. Returns (y, new cache entry)."""
    u = x @ params["w_x"]
    gate = x @ params["w_gate"]
    u, new_tail = causal_conv1d(u, params["conv"], cache["conv"])
    log_a, b_scale = _gates(params, u)
    h = (torch.exp(log_a[:, 0]) * cache["h"].to(torch.float32)
         + b_scale[:, 0] * u[:, 0].to(torch.float32))
    y = F.gelu(gate[:, 0].to(torch.float32), approximate="tanh") * h
    out = (y.to(x.dtype) @ params["w_out"])[:, None]
    return out, {"h": h.to(x.dtype), "conv": new_tail}


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
