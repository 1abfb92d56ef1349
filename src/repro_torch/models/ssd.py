"""Mamba-2 SSD (state-space duality) mixer (counterpart of
``repro/models/ssd.py``).

The chunked algorithm of the paper (arXiv:2405.21060, §6): the sequence is
split into chunks of Q tokens; within a chunk the SSM runs in its
quadratic (attention-like) dual form, across chunks a recurrence carries
the (H, P, N) state. :func:`ssd_chunked` is
:func:`repro_torch.kernels.ssd.ops.ssd_chunked`: kernel K5 on the card,
its plain version (a line-by-line port of the reference's jnp form) on the
CPU. Decode runs one recurrent step in plain torch, as the reference does.

Single B/C group (G=1). The reference's casts are kept: the state is
stored in the input's dtype after a sequence and after a step, and
everything between is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd.ops import ssd_chunked
from .layers import (
    EMBED, ParamSpec, SSM_HEADS, SSM_INNER, keep_grad_layout, rms_norm,
)
from .rglru import causal_conv1d

__all__ = ["ssd_cache_init", "ssd_chunked", "ssd_sequence", "ssd_specs",
           "ssd_step"]


def ssd_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h), (EMBED, SSM_INNER)),
        "conv": ParamSpec((cfg.conv_width, conv_ch), (None, SSM_INNER),
                          init="small"),
        "a_log": ParamSpec((h,), (SSM_HEADS,), init="zeros"),
        "dt_bias": ParamSpec((h,), (SSM_HEADS,), init="zeros"),
        "d_skip": ParamSpec((h,), (SSM_HEADS,), init="ones"),
        "norm_gamma": ParamSpec((di,), (SSM_INNER,), init="zeros"),
        "out_proj": ParamSpec((di, d), (SSM_INNER, EMBED)),
    }


def _split_proj(params, x: torch.Tensor, cfg: ModelConfig):
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    # on DTensors the projection's gradient comes back in its own layout
    # (the split's consumers may hand it back sequence-sharded, which the
    # weight gradient's flattened (B, S) cannot take)
    z, xin, bmat, cmat, dt = torch.split(
        keep_grad_layout(x @ params["in_proj"]), [di, di, n, n, h], dim=-1)
    return z, torch.cat([xin, bmat, cmat], dim=-1), dt


def ssd_sequence(params, x: torch.Tensor, cfg: ModelConfig,
                 state: dict | None = None):
    """Full mamba2 block over a sequence. x: (B, S, D). Returns (y, {'h':
    ..., 'conv': ...})."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    f32 = torch.float32
    z, conv_in, dt = _split_proj(params, x, cfg)
    conv_out, conv_tail = causal_conv1d(
        conv_in, params["conv"], None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # its threshold of 20, where log1p(exp(-x)) < 2.1e-9 is below half a
    # float32 unit of x (>= 9.5e-7), so both round to x there
    dtp = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))
    a_neg = -torch.exp(params["a_log"].to(f32))
    bsz, s, _ = x.shape
    xh = xin.reshape(bsz, s, h, p)
    y, h_last = ssd_chunked(xh, dtp, a_neg, bmat, cmat, cfg.ssm_chunk,
                            None if state is None else state["h"])
    y = y + params["d_skip"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_gamma"], cfg.norm_eps)
    out = y @ params["out_proj"]
    return out, {"h": h_last.to(x.dtype), "conv": conv_tail}


def ssd_step(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One decode step. x: (B, 1, D); cache {'h': (B, H, P, N), 'conv':
    ...}. Returns (y, new cache entry)."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    f32 = torch.float32
    z, conv_in, dt = _split_proj(params, x, cfg)
    conv_out, conv_tail = causal_conv1d(conv_in, params["conv"],
                                        cache["conv"])
    conv_out = F.silu(conv_out)[:, 0]
    xin, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)
    dtp = F.softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))  # (B,H)
    a = torch.exp(dtp * -torch.exp(params["a_log"].to(f32)))         # (B,H)
    xh = xin.reshape(-1, h, p).to(f32)
    dbx = dtp[..., None, None] * torch.einsum(
        "bn,bhp->bhpn", bmat.to(f32), xh)
    h_new = cache["h"].to(f32) * a[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h_new, cmat.to(f32))
    y = y + params["d_skip"].to(f32)[None, :, None] * xh
    y = y.reshape(-1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, 0]), params["norm_gamma"], cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None]
    return out, {"h": h_new.to(x.dtype), "conv": conv_tail}


def ssd_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {
        "h": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=dtype, device=device),
        "conv": torch.zeros(
            (batch, cfg.conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state),
            dtype=dtype, device=device),
    }
