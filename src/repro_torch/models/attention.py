"""Attention: GQA projections and the three execution paths (counterpart of
``repro/models/attention.py``).

* :func:`flash_attention` — causal (or full) attention over a sequence;
* :func:`local_attention` — causal sliding-window attention;
* :func:`decode_attention` — one query step against a cache.

The JAX package computes the first two as XLA scans (a kv-block scan and a
q-block scan) and keeps the Pallas kernel ``repro/kernels/attention`` as
the same schedule for real TPUs. Here both *are* that kernel:
:func:`repro_torch.kernels.attention.ops.flash_attention`, which on a CUDA
tensor launches K4 and on a CPU tensor takes its plain version. Decode
attention has no kernel in either package and stays plain torch.

The weight layouts are the JAX package's (``wq (d, hq, h)``, ``wk``/``wv
(d, hkv, h)``, ``wo (hq, h, d)``). All softmax arithmetic is float32
whatever the compute dtype. Cross attention (an encoder-decoder's
decoder reading the encoder's memory) takes the sequence path through K4,
non-causal, with the query length the decoder's and the key length the
source's; its decode step reads the cross cache and writes nothing. The
split-KV decode of a mesh is not ported yet (``ROADMAP.md`` queue 1 item
3).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..kernels.attention import ops as attn_ops
from .layers import (
    EMBED, HEADDIM, KVHEADS, QHEADS, ParamSpec, apply_rope, qk_norm, softcap,
)

NEG_INF = -2.0e38


# --------------------------------------------------------------------------- specs


def attn_specs(cfg: ModelConfig, cross: bool = False
               ) -> dict[str, ParamSpec]:
    d, h, hq, hkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": ParamSpec((d, hq, h), (EMBED, QHEADS, HEADDIM)),
        "wk": ParamSpec((d, hkv, h), (EMBED, KVHEADS, HEADDIM)),
        "wv": ParamSpec((d, hkv, h), (EMBED, KVHEADS, HEADDIM)),
        "wo": ParamSpec((hq, h, d), (QHEADS, HEADDIM, EMBED)),
    }
    if cfg.qk_norm and not cross:
        specs["q_gamma"] = ParamSpec((h,), (HEADDIM,), init="zeros")
        specs["k_gamma"] = ParamSpec((h,), (HEADDIM,), init="zeros")
    return specs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_q(params, x, cfg: ModelConfig, positions, *, rope: bool = True):
    q = _heads(x, params["wq"])
    if cfg.qk_norm and "q_gamma" in params:
        q = qk_norm(q, params["q_gamma"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta, mode=cfg.rope_mode,
                       sections=cfg.mrope_sections)
    return q


def project_kv(params, x, cfg: ModelConfig, positions, *, rope: bool = True):
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qk_norm and "k_gamma" in params:
        k = qk_norm(k, params["k_gamma"], cfg.norm_eps)
    if rope:
        k = apply_rope(k, positions, theta=cfg.rope_theta, mode=cfg.rope_mode,
                       sections=cfg.mrope_sections)
    return k, v


def o_proj(params, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = params["wo"].shape
    return ctx.flatten(-2) @ params["wo"].reshape(h * k, d)


# --------------------------------------------------------------------------- sequence paths (K4)


def _no_offset(q_offset: int) -> None:
    # K4, like the Pallas kernel, counts query rows from 0; a chunked
    # prefill's offset would shift the causal and window masks
    if q_offset != 0:
        raise NotImplementedError(
            f"q_offset={q_offset}: the attention kernel masks from query "
            "row 0 (no chunked prefill)"
        )


def flash_attention(
    q: torch.Tensor,             # (B, Sq, Hq, D)
    k: torch.Tensor,             # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,             # 0 => unbounded
    q_offset: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Global attention through K4 (``models/attention.py:225``)."""
    _no_offset(q_offset)
    return attn_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=attn_softcap)


def local_attention(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int,
    q_offset: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Causal sliding-window attention through K4
    (``models/attention.py:252``). A window at or past the sequence masks
    nothing more than causality, as the reference's ``min(window, s)``."""
    _no_offset(q_offset)
    return attn_ops.flash_attention(q, k, v, causal=True, window=window,
                                    softcap=attn_softcap)


# --------------------------------------------------------------------------- decode


def decode_attention(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_cache: torch.Tensor,       # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,
    cache_len: int,              # valid cache rows (incl. this step)
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = (q.to(torch.float32) * (1.0 / math.sqrt(d))).reshape(b, 1, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(torch.float32))
    if attn_softcap > 0:
        s = softcap(s, attn_softcap)
    k_idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = k_idx < cache_len
    if window > 0:
        mask &= k_idx >= cache_len - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


# --------------------------------------------------------------------------- int8 KV cache


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8. x: (..., S, H, D) ->
    (int8 same shape, bfloat16 scale (..., S, H, 1))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)


def _cache_is_int8(cache: dict) -> bool:
    return "k_scale" in cache


# --------------------------------------------------------------------------- block-level API


def attention_sequence(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    local: bool,
    causal: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    q = project_q(params, x, cfg, positions)
    k, v = project_kv(params, x, cfg, positions)
    if local:
        ctx = local_attention(q, k, v, window=cfg.window,
                              attn_softcap=cfg.attn_logit_softcap)
    else:
        ctx = flash_attention(q, k, v, causal=causal,
                              attn_softcap=cfg.attn_logit_softcap)
    return o_proj(params, ctx), (k, v)


def attention_step(
    params,
    x: torch.Tensor,              # (B, 1, D)
    position: torch.Tensor,       # (B, 1) or (3, B, 1) for mrope
    cache: dict,                  # {"k": (B,Smax,Hkv,D), "v": ...}
    cache_len: int,               # valid rows AFTER this token is appended
    cfg: ModelConfig,
    *,
    local: bool,
    cross: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Single decode step; returns (out, cache). The JAX package returns a
    new cache (its old one donated); here row ``cache_len - 1`` of the
    preallocated cache is written in place and the same dict returned. A
    ``cross`` step projects q without RoPE and reads every row of the
    cross cache (the encoder's K/V), writing nothing."""
    q = project_q(params, x, cfg, position, rope=not cross)
    if cross:
        ctx = decode_attention(q, cache["k"], cache["v"], cache["k"].shape[1],
                               attn_softcap=cfg.attn_logit_softcap)
        return o_proj(params, ctx), cache
    k, v = project_kv(params, x, cfg, position)
    window = cfg.window if local else 0
    idx = cache_len - 1
    if _cache_is_int8(cache):
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        cache["k"][:, idx:idx + 1] = kq
        cache["v"][:, idx:idx + 1] = vq
        cache["k_scale"][:, idx:idx + 1] = ksc
        cache["v_scale"][:, idx:idx + 1] = vsc
        k_cache = dequantize_kv(cache["k"], cache["k_scale"]).to(k.dtype)
        v_cache = dequantize_kv(cache["v"], cache["v_scale"]).to(v.dtype)
    else:
        cache["k"][:, idx:idx + 1] = k
        cache["v"][:, idx:idx + 1] = v
        k_cache, v_cache = cache["k"], cache["v"]
    ctx = decode_attention(q, k_cache, v_cache, cache_len, window=window,
                           attn_softcap=cfg.attn_logit_softcap)
    return o_proj(params, ctx), cache
