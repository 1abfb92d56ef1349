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
source's; its decode step reads the cross cache and writes nothing.

Under a mesh (:func:`repro_torch.compat.set_mesh`) whose ``"model"`` axis
divides a self-attention cache's sequence capacity, a decode step takes
:func:`decode_step_split_kv`, the reference's flash-decoding on the mesh:
each ``model`` rank holds a stripe of ``capacity / n`` cache rows (the
cache's leaves are DTensors, ``Shard(1)`` over ``model``, made by
:func:`striped`), the owning rank writes the new token, every rank
computes the partial max, sum and output over its stripe, and an
all-reduce MAX and two all-reduce SUMs over the ``model`` group combine
them. It is plain torch, as the reference's ``jnp`` under ``shard_map``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..compat import all_reduce, current_mesh, mesh_axes
from ..configs.base import ModelConfig
from ..kernels.attention import ops as attn_ops
from .layers import (
    BATCH_AXES, EMBED, HEADDIM, KVHEADS, MODEL_AXIS, QHEADS, ParamSpec,
    apply_rope, constrain, constrain_bshd, keep_grad_layout, qk_norm,
    softcap,
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
    """einsum("bsd,dhk->bshk") as one matrix product. On DTensors the
    product is pinned before its last dim splits into heads: over 'model'
    where the heads divide it, else whole (a shard must hold whole
    heads)."""
    d, h, k = w.shape
    if isinstance(w, DTensor) and any(
            isinstance(p, Shard) and w.shape[p.dim] == 1
            for p in w.placements):
        # a dim of one head "split" over a mesh dim of one rank: whole
        # (the same bytes), so that the reshape may merge it
        w = w.redistribute(w.device_mesh, [
            Replicate() if isinstance(p, Shard) and w.shape[p.dim] == 1
            else p for p in w.placements])
    y = x @ keep_grad_layout(w.reshape(d, h * k))
    if isinstance(y, DTensor):
        n = dict(zip(y.device_mesh.mesh_dim_names or (),
                     y.device_mesh.shape)).get(MODEL_AXIS, 1)
        y = constrain(y, (BATCH_AXES, None,
                          MODEL_AXIS if h % n == 0 else None))
    return y.unflatten(-1, (h, k))


def project_q(params, x, cfg: ModelConfig, positions, *, rope: bool = True):
    q = constrain_bshd(_heads(x, params["wq"]))
    if cfg.qk_norm and "q_gamma" in params:
        q = qk_norm(q, params["q_gamma"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta, mode=cfg.rope_mode,
                       sections=cfg.mrope_sections)
    return q


def project_kv(params, x, cfg: ModelConfig, positions, *, rope: bool = True):
    k = constrain_bshd(_heads(x, params["wk"]))
    v = constrain_bshd(_heads(x, params["wv"]))
    if cfg.qk_norm and "k_gamma" in params:
        k = qk_norm(k, params["k_gamma"], cfg.norm_eps)
    if rope:
        k = apply_rope(k, positions, theta=cfg.rope_theta, mode=cfg.rope_mode,
                       sections=cfg.mrope_sections)
    return k, v


def o_proj(params, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = params["wo"].shape
    return (keep_grad_layout(ctx.flatten(-2))
            @ keep_grad_layout(params["wo"].reshape(h * k, d)))


# --------------------------------------------------------------------------- sequence paths (K4)


def _model_split(t: torch.Tensor) -> int:
    """How many ways ``t`` (a DTensor, heads at dim 2) is split over its
    mesh's model axis, or 1."""
    if not isinstance(t, DTensor) or MODEL_AXIS not in (
            t.device_mesh.mesh_dim_names or ()):
        return 1
    m = t.device_mesh.mesh_dim_names.index(MODEL_AXIS)
    return t.device_mesh.shape[m] if t.placements[m] == Shard(2) else 1


def _expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K and V as the kernel can take them beside q's shard: where q's
    heads are split over 'model' and the KV heads are not, each KV head
    repeated ``Hq / Hkv`` times and pinned like q (the reference's
    ``_expand_kv``, ``repro/models/attention.py:80-91``), so that every
    rank holds the KV heads of its own query heads. Elsewhere (no mesh,
    or the KV heads split alike) K and V as they are: the kernel maps
    each query head to its KV head itself."""
    if _model_split(q) == _model_split(k):
        return k, v
    g = q.shape[2] // k.shape[2]
    return tuple(constrain_bshd(t.repeat_interleave(g, dim=2))
                 for t in (k, v))


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
    """Global attention through K4 (``models/attention.py:225``).
    ``q_offset`` is the global index of query row 0 (a chunked prefill's
    chunk over its whole prefix of keys); every mask reads query row ``i``
    as ``q_offset + i``. A call that leaves a row no live key raises
    ``ValueError`` (:func:`~repro_torch.kernels.attention.ops.flash_attention`)."""
    return attn_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=attn_softcap, q_offset=q_offset)


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
    nothing more than causality, as the reference's ``min(window, s)``.
    q and k share their positions here, so ``q_offset`` shifts query and
    key indices alike, as in the reference (whose only term of it beyond
    that masks the padded rows it drops): any offset computes what 0
    does, and K4 is called at 0."""
    del q_offset
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


# --------------------------------------------------------------------------- split-KV decode


def split_kv_layout(capacity: int):
    """``(mesh, n, rank)`` when the ambient mesh has a ``"model"`` axis of
    ``n`` ranks that divides ``capacity`` (``rank`` this process's place
    on it), else None: the reference's ``_split_kv_available`` test."""
    mesh = current_mesh()
    if mesh is None:
        return None
    n = mesh_axes(mesh).get("model")
    if n is None or capacity % n or capacity < n:
        return None
    return mesh, n, mesh.get_local_rank("model")


def _split_kv_available(cache_k: torch.Tensor) -> bool:
    """True when the ambient mesh has a 'model' axis that divides the
    cache's global sequence capacity (a DTensor's global shape)."""
    return split_kv_layout(cache_k.shape[1]) is not None


def striped(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """A self-attention cache leaf of ``capacity`` rows whose first rows
    are ``rows`` (B, S <= capacity, ...), the rest zeros. Under a split-KV
    mesh only this rank's stripe of it is made, rows ``rank * capacity / n``
    on, as a DTensor of the global shape (``Shard(1)`` on ``model``,
    ``Replicate()`` on the other mesh dims); otherwise the whole leaf
    (``rows`` itself when it has ``capacity`` rows)."""
    if isinstance(rows, DTensor):          # a prefill's K/V on a mesh
        rows = rows.full_tensor()
    layout = split_kv_layout(capacity)
    if layout is None:
        pad_n = capacity - rows.shape[1]
        if pad_n <= 0:
            return rows
        return torch.cat([rows, rows.new_zeros(
            (rows.shape[0], pad_n, *rows.shape[2:]))], dim=1)
    mesh, n, rank = layout
    s_loc = capacity // n
    local = rows.new_zeros((rows.shape[0], s_loc, *rows.shape[2:]))
    mine = rows[:, rank * s_loc:(rank + 1) * s_loc]
    local[:, :mine.shape[1]] = mine
    placements = [Shard(1) if name == "model" else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def decode_step_split_kv(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_new: torch.Tensor,         # (B, 1, Hkv, D)
    v_new: torch.Tensor,
    cache: dict,                 # k/v DTensors (B, Smax, Hkv, D), Shard(1) on 'model'
    cache_len: int,
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    write: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One decode step with the KV ring sharded over 'model' by sequence
    (``repro/models/attention.py`` ``decode_step_split_kv``).

    A ``local_map`` over the cache's mesh (the reference's ``shard_map``,
    manual over 'model'): the cache enters in its own placements, q and
    the new row replicated over 'model' and laid out like the cache's
    batch elsewhere. The rank whose stripe holds row ``cache_len - 1``
    writes the new token there (quantized for an int8 cache); the others
    write nothing. Every rank computes float32 scores over its stripe (the
    softcap, then the length and window masks by global row), its partial
    max, and after an all-reduce MAX over ``model``, ``exp(s - m)``, whose
    sum and product with V two all-reduce SUMs add up; the output is ``o /
    max(l, 1e-37)``. An int8 cache is dequantized straight to float32.
    A plain q (and new row) is taken as replicated, and the output comes
    back plain. With ``write=False`` (a cross cache, the encoder's K/V)
    nothing is written and ``k_new``/``v_new`` are None. Returns (out,
    cache), the cache written in place."""
    mesh = cache["k"].device_mesh
    n = mesh_axes(mesh)["model"]
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    smax = cache["k"].shape[1]
    s_loc = smax // n
    start = rank * s_loc
    tgt = (cache_len - 1) - start
    int8 = _cache_is_int8(cache)
    names = list(cache)
    cache_pl = tuple(cache["k"].placements)
    row_pl = tuple(Replicate() if p == Shard(1) else p for p in cache_pl)

    def stripe(q, k_new, v_new, *leaves):
        local = dict(zip(names, leaves))          # views of the stripes
        if write and 0 <= tgt < s_loc:
            if int8:
                (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
                new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            else:
                new = {"k": k_new, "v": v_new}
            for name, x in new.items():
                local[name][:, tgt:tgt + 1] = x
        if int8:
            kf = dequantize_kv(local["k"], local["k_scale"])
            vf = dequantize_kv(local["v"], local["v_scale"])
        else:
            kf = local["k"].to(torch.float32)
            vf = local["v"].to(torch.float32)
        b, _, hq, d = q.shape
        hkv = kf.shape[2]
        g = hq // hkv
        qg = (q.to(torch.float32).reshape(b, 1, hkv, g, d)
              * (1.0 / math.sqrt(d)))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
        if attn_softcap > 0:
            s = softcap(s, attn_softcap)
        k_idx = start + torch.arange(s_loc, device=q.device)
        mask = k_idx < cache_len
        if window > 0:
            mask &= k_idx >= cache_len - window
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        m = all_reduce(s.amax(dim=-1), "max", group)
        p = torch.exp(s - m[..., None])
        l = all_reduce(p.sum(dim=-1), "sum", group)
        o = all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", p, vf),
                              "sum", group)
        out = o / torch.clamp(l, min=1e-37).permute(0, 3, 1, 2)[..., None]
        return out.reshape(b, 1, hq, d).to(q.dtype)

    plain = not isinstance(q, DTensor)
    rows = [DTensor.from_local(t, mesh, row_pl, run_check=False) if plain
            else t for t in ((q, k_new, v_new) if write else (q,))]
    n_rows = len(rows)

    def body(*args):
        new = args[1:n_rows] if write else (None, None)
        return stripe(args[0], *new, *args[n_rows:])

    out = local_map(body, out_placements=list(row_pl),
                    in_placements=(row_pl,) * n_rows
                    + (cache_pl,) * len(names),
                    device_mesh=mesh, redistribute_inputs=True)(
        *rows, *(cache[name] for name in names))
    return (out.to_local() if plain else out), cache


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
    ke, ve = _expand_kv(q, k, v)
    if local:
        ctx = local_attention(q, ke, ve, window=cfg.window,
                              attn_softcap=cfg.attn_logit_softcap)
    else:
        ctx = flash_attention(q, ke, ve, causal=causal,
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
    preallocated cache is written in place and the same dict returned;
    under a split-KV mesh the step is :func:`decode_step_split_kv`. A
    ``cross`` step projects q without RoPE and reads every row of the
    cross cache (the encoder's K/V), writing nothing."""
    q = project_q(params, x, cfg, position, rope=not cross)
    if cross:
        if isinstance(cache["k"], DTensor) and _split_kv_available(
                cache["k"]):
            ctx, _ = decode_step_split_kv(
                q, None, None, cache, cache["k"].shape[1],
                attn_softcap=cfg.attn_logit_softcap, write=False)
        else:
            ctx = decode_attention(q, cache["k"], cache["v"],
                                   cache["k"].shape[1],
                                   attn_softcap=cfg.attn_logit_softcap)
        return o_proj(params, ctx), cache
    k, v = project_kv(params, x, cfg, position)
    window = cfg.window if local else 0
    if _split_kv_available(cache["k"]):
        ctx, cache = decode_step_split_kv(
            q, k, v, cache, cache_len,
            window=window, attn_softcap=cfg.attn_logit_softcap)
        return o_proj(params, ctx), cache
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
