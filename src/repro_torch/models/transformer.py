"""Decoder (and encoder-decoder) stack (counterpart of
``repro/models/transformer.py``).

Layers are ``group_count`` repetitions of ``cfg.block_pattern`` (gemma2:
``("local_attn", "attn")``; recurrentgemma: ``("rec", "rec",
"local_attn")``; mamba2: ``("ssd",)``) plus a tail for non-divisible
depths. The JAX package stacks each pattern position's parameters along a
leading 'layers' axis and drives the stack with ``jax.lax.scan``; here the
parameters are one module per layer (``groups.<i>.<g>`` is repetition
``g`` of pattern position ``i``) and a Python loop runs them in the same
order: for each repetition, the pattern's positions in turn, then the
tail. With gradients on and ``cfg.remat == "block"`` (the default), each
repetition runs under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, the counterpart of the reference wrapping each scan
group in ``jax.checkpoint`` (``repro/models/transformer.py:97-111``): its
activations are recomputed in the backward, so a training step runs each
group's forward, K4 included, twice. The sequence path returns the MoE
aux losses (load balance ``lb`` and router ``z``) summed over the layers,
out of the checkpoints too; the decode step drops them, as the
reference's does.

An encoder-decoder (``cfg.encoder_layers > 0``, seamless) adds an
``encoder`` section, ``encoder.blocks.<l>`` one ``attn`` block a layer and
a ``final_ln``: :func:`encoder_apply` runs it bidirectionally (K4 with
``causal=False``) over the frontend's embeddings, with RoPE at positions
``0 .. S_enc - 1``, each layer under a checkpoint where remat applies. Each
decoder attention block then has ``ln_cross`` and ``cross`` (attention
parameters without qk-norm gains): K and V projected from the encoder's
memory and q from ``ln_cross``, neither rotated, through K4 non-causal
with ``Sq`` the decoder's length and ``Skv`` the source's.

Caches mirror the structure: ``{"groups": {i: [entry per repetition]},
"tail": {i: entry}}``. An attention entry is ``{"self": {"k", "v"[,
"k_scale", "v_scale"]}}`` of ``(B, capacity, Hkv, D)``, written in place
row by row, and in an encoder-decoder ``"cross": {"k", "v"}`` of ``(B,
cross_len, Hkv, D)`` in the compute dtype (also under an int8 KV cache),
which decoding reads and never writes; a state entry (``rec``, ``ssd``) is
``{"h", "conv"}`` of a constant size, replaced by a new one at every
decode step.

Block kinds: ``attn`` and ``local_attn`` with a dense or an MoE FFN
(:mod:`.moe`, routed by ``EPContext``), ``rec`` (RG-LRU with a dense MLP,
kernel K6) and ``ssd`` (Mamba-2, kernel K5).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..spans import span
from . import attention as attn
from .layers import (
    BATCH_AXES, MODEL_AXIS, constrain, constrain_bsd, embed_logits, gather_sp,
    embed_lookup, embed_specs, mlp_apply, mlp_specs, rms_norm, rms_norm_spec,
    softcap, stack_specs,
)
from .moe import EPContext, moe_apply, moe_specs
from .rglru import rglru_cache_init, rglru_sequence, rglru_specs, rglru_step
from .ssd import ssd_cache_init, ssd_sequence, ssd_specs, ssd_step

Params = Any
Cache = Any

# --------------------------------------------------------------------------- specs


def _ffn_specs(cfg: ModelConfig) -> dict:
    return moe_specs(cfg) if cfg.is_moe else mlp_specs(cfg.d_model, cfg.d_ff,
                                                       cfg.act)


def block_specs(cfg: ModelConfig, kind: str, cross: bool = False) -> dict:
    d = cfg.d_model
    if kind == "ssd":
        return {"ln1": rms_norm_spec(d), "ssd": ssd_specs(cfg)}
    if kind == "rec":
        return {
            "ln1": rms_norm_spec(d),
            "rec": rglru_specs(cfg),
            "ln2": rms_norm_spec(d),
            "ffn": mlp_specs(d, cfg.d_ff, cfg.act),
        }
    if kind not in ("attn", "local_attn"):
        raise ValueError(f"unknown block kind {kind!r}")
    specs = {
        "ln1": rms_norm_spec(d),
        "attn": attn.attn_specs(cfg),
        "ln2": rms_norm_spec(d),
        "ffn": _ffn_specs(cfg),
    }
    if cross:
        specs["ln_cross"] = rms_norm_spec(d)
        specs["cross"] = attn.attn_specs(cfg, cross=True)
    return specs


def decoder_specs(cfg: ModelConfig) -> dict:
    """The JAX package's parameter spec tree, stacked groups (and the
    encoder's stacked blocks) included."""
    cross = cfg.encoder_layers > 0
    specs = {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
        "final_ln": rms_norm_spec(cfg.d_model),
        "groups": {
            str(i): stack_specs(block_specs(cfg, kind, cross),
                                cfg.group_count)
            for i, kind in enumerate(cfg.block_pattern)
        },
        "tail": {
            str(i): block_specs(cfg, kind, cross)
            for i, kind in enumerate(cfg.tail_pattern)
        },
    }
    if cross:
        specs["encoder"] = {
            "blocks": stack_specs(block_specs(cfg, "attn"),
                                  cfg.encoder_layers),
            "final_ln": rms_norm_spec(cfg.d_model),
        }
    return specs


def layer_specs(cfg: ModelConfig) -> dict:
    """:func:`decoder_specs` with each stacked group split into a list of
    ``group_count`` per-layer spec trees, and the encoder's stack into a
    list of ``encoder_layers`` (the port's module tree)."""
    specs = decoder_specs(cfg)
    cross = cfg.encoder_layers > 0
    specs["groups"] = {
        str(i): [block_specs(cfg, kind, cross)
                 for _ in range(cfg.group_count)]
        for i, kind in enumerate(cfg.block_pattern)
    }
    if cross:
        specs["encoder"]["blocks"] = [block_specs(cfg, "attn")
                                      for _ in range(cfg.encoder_layers)]
    return specs


def layer_runs(params: Params, cfg: ModelConfig):
    """The decoder's layers in execution order, in runs of ``(kind, layer
    params, (section, i, g))``: one run for each repetition of the pattern
    (what remat recomputes as one), then the tail, a layer a run (``g`` is
    None there)."""
    for g in range(cfg.group_count):
        yield [(kind, params["groups"][str(i)][g], ("groups", str(i), g))
               for i, kind in enumerate(cfg.block_pattern)]
    for i, kind in enumerate(cfg.tail_pattern):
        yield [(kind, params["tail"][str(i)], ("tail", str(i), None))]


def layers_in_order(params: Params, cfg: ModelConfig):
    """``(kind, layer params, (section, i, g))`` in execution order."""
    for run in layer_runs(params, cfg):
        yield from run


def _entry(cache: Cache, where) -> dict:
    section, i, g = where
    return cache[section][i] if g is None else cache[section][i][g]


# --------------------------------------------------------------------------- blocks


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h`` in the residual stream's layout (``constrain_bsd``), ``h``
    moved there by an explicit redistribute: DTensor's own operand
    redistribution inside the add is invisible to autograd, and would hand
    ``h``'s producer its gradient in the sequence-parallel layout."""
    return constrain_bsd(x + constrain_bsd(h))


def _norm(x: torch.Tensor, gamma: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """A block's pre-norm, its output out of the sequence-parallel layout
    (``gather_sp``): the mixers' and FFNs' products flatten (B, S) into
    one dim, which DTensor cannot shard on both."""
    return gather_sp(rms_norm(x, gamma, cfg.norm_eps))


def _ffn_apply(params, x: torch.Tensor, cfg: ModelConfig, ep: EPContext
               ) -> tuple[torch.Tensor, dict]:
    if cfg.is_moe:
        with span("moe"):
            return moe_apply(params, x, cfg, ep)
    with span("block.mlp"):
        return mlp_apply(params, x, cfg.act), {}


def block_apply_seq(params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, kind: str, ep: EPContext = EPContext(),
                    *, causal: bool = True,
                    memory: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, dict, dict]:
    """One block over a full sequence. Returns (x, cache_entry, aux): the
    MoE FFN's aux losses, or {}. With the encoder's ``memory`` (B, S_enc,
    D), an attention block that has cross parameters attends to it after
    its self attention."""
    if kind == "ssd":
        h, state = ssd_sequence(
            params["ssd"], _norm(x, params["ln1"], cfg), cfg)
        return _residual(x, h), state, {}
    if kind == "rec":
        h, (hl, tail) = rglru_sequence(
            params["rec"], _norm(x, params["ln1"], cfg), cfg)
        x = _residual(x, h)
        with span("block.mlp"):
            h = mlp_apply(params["ffn"], _norm(x, params["ln2"], cfg),
                          cfg.act)
        return _residual(x, h), {"h": hl, "conv": tail}, {}
    with span("block.attention"):
        h, (k, v) = attn.attention_sequence(
            params["attn"], _norm(x, params["ln1"], cfg), positions,
            cfg, local=kind == "local_attn", causal=causal,
        )
    x = _residual(x, h)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = attn.quantize_kv(k)
        vq, vs = attn.quantize_kv(v)
        cache = {"self": {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}}
    else:
        cache = {"self": {"k": k, "v": v}}
    if memory is not None and "cross" in params:
        with span("block.attention"):
            mem_k, mem_v = attn.project_kv(params["cross"], memory, cfg,
                                           None, rope=False)
            q = attn.project_q(params["cross"],
                               _norm(x, params["ln_cross"], cfg),
                               cfg, None, rope=False)
            ctx = attn.flash_attention(q, *attn._expand_kv(q, mem_k, mem_v),
                                       causal=False,
                                       attn_softcap=cfg.attn_logit_softcap)
            h = attn.o_proj(params["cross"], ctx)
        x = _residual(x, h)
        cache["cross"] = {"k": mem_k, "v": mem_v}
    h, aux = _ffn_apply(params["ffn"],
                        _norm(x, params["ln2"], cfg), cfg, ep)
    return _residual(x, h), cache, aux


def block_apply_step(params, x: torch.Tensor, position: torch.Tensor,
                     cache: dict, cache_len: int, cfg: ModelConfig, kind: str,
                     ep: EPContext = EPContext()
                     ) -> tuple[torch.Tensor, dict]:
    """One block for one token (B, 1, D). Returns (x, entry): attention
    writes its K/V row into ``cache`` and returns it (reading the cross
    entry, where there is one, after the self attention); a state block
    returns a new entry and leaves ``cache`` as it was."""
    if kind == "ssd":
        h, state = ssd_step(
            params["ssd"], _norm(x, params["ln1"], cfg), cache,
            cfg)
        return _residual(x, h), state
    if kind == "rec":
        h, state = rglru_step(
            params["rec"], _norm(x, params["ln1"], cfg), cache,
            cfg)
        x = _residual(x, h)
        with span("block.mlp"):
            h = mlp_apply(params["ffn"], _norm(x, params["ln2"], cfg),
                          cfg.act)
        return _residual(x, h), state
    with span("block.attention"):
        h, _ = attn.attention_step(
            params["attn"], _norm(x, params["ln1"], cfg), position,
            cache["self"], cache_len, cfg, local=kind == "local_attn",
        )
    x = _residual(x, h)
    if "cross" in cache and "cross" in params:
        with span("block.attention"):
            h, _ = attn.attention_step(
                params["cross"], _norm(x, params["ln_cross"], cfg),
                position, cache["cross"], cache_len, cfg, local=False,
                cross=True,
            )
        x = _residual(x, h)
    h, _ = _ffn_apply(params["ffn"], _norm(x, params["ln2"], cfg),
                      cfg, ep)
    return _residual(x, h), cache


# --------------------------------------------------------------------------- encoder


def _remat(cfg: ModelConfig, want_cache: bool = False) -> bool:
    if cfg.remat not in ("block", "none"):
        raise NotImplementedError(
            f"remat={cfg.remat!r}: the port has 'block' and 'none'")
    return (cfg.remat == "block" and torch.is_grad_enabled()
            and not want_cache)


def encoder_apply(params, embeds: torch.Tensor, cfg: ModelConfig,
                  ep: EPContext = EPContext()) -> torch.Tensor:
    """The bidirectional encoder over the frontend's embeddings (B, S_enc,
    D): RoPE positions ``0 .. S_enc - 1``, every layer an ``attn`` block
    with ``causal=False``, then ``final_ln``. With gradients on and
    ``cfg.remat == "block"``, each layer runs under a checkpoint (the
    reference's ``jax.checkpoint`` of its per-layer scan body)."""
    b, s = embeds.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=embeds.device)[None].expand(b, s)

    def body(x, layer):
        return block_apply_seq(layer, x, positions, cfg, "attn", ep,
                               causal=False)[0]

    remat = _remat(cfg)
    x = embeds
    for layer in params["blocks"]:
        x = (checkpoint(body, x, layer, use_reentrant=False) if remat
             else body(x, layer))
    return _norm(x, params["final_ln"], cfg)


# --------------------------------------------------------------------------- decoder


def _head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    with span("model.head"):
        x = _norm(x, params["final_ln"], cfg)
        logits = constrain(embed_logits(params["embed"], x),
                           (BATCH_AXES, None, MODEL_AXIS))
        if cfg.final_logit_softcap > 0:
            logits = softcap(logits, cfg.final_logit_softcap)
        return logits


# the MoE aux losses, summed over the layers
_MOE_AUX = ("lb", "z")


def _sum_aux(acc: dict, new: dict) -> dict:
    out = dict(acc)
    for k, v in new.items():
        out[k] = out.get(k, 0.0) + v
    return out


def _run_layers(x: torch.Tensor, run: list, positions: torch.Tensor,
                cfg: ModelConfig, ep: EPContext,
                memory: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, list, dict]:
    """One run of :func:`layer_runs` over ``x``: ``(x, cache entries, aux
    summed over the run)``."""
    entries, aux = [], {}
    for kind, layer, _ in run:
        x, entry, a = block_apply_seq(layer, x, positions, cfg, kind, ep,
                                      memory=memory)
        entries.append(entry)
        aux = _sum_aux(aux, a)
    return x, entries, aux


def _run_checkpointed(x: torch.Tensor, run: list, positions: torch.Tensor,
                      cfg: ModelConfig, ep: EPContext,
                      memory: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, dict]:
    """:func:`_run_layers` under a checkpoint (its activations recomputed
    in the backward); the aux losses leave it beside ``x``. The encoder's
    memory enters as an input of the checkpoint, so that every cross
    block's K/V carries its gradient back to the encoder."""

    def body(x, memory, run):
        x, _, aux = _run_layers(x, run, positions, cfg, ep, memory)
        return (x, *(aux[k] for k in sorted(aux)))

    x, *values = checkpoint(body, x, memory, run, use_reentrant=False)
    return x, dict(zip(sorted(_MOE_AUX if cfg.is_moe else ()), values))


def decoder_apply(
    params: Params,
    tokens: torch.Tensor,        # (B, S) int
    positions: torch.Tensor,     # (B, S) or (3, B, S)
    cfg: ModelConfig,
    ep: EPContext = EPContext(),
    *,
    memory: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    last_only: bool = False,
) -> tuple[torch.Tensor, dict, Optional[Cache]]:
    """Returns (logits (B, S, V), aux losses, cache-or-None): the aux
    losses are the MoE layers' ``lb`` and ``z`` summed over the layers (the
    reference's pre-declared float32 zeros when no layer adds to them), {}
    for the other archs. ``last_only`` applies the final norm, head and
    softcap to the last position alone and returns (B, 1, V): the same
    values as the full logits' last row, since each position's norm and
    head are its own. With gradients on and no cache asked for (the loss)
    and ``cfg.remat == "block"``, each repetition of the pattern runs under
    a checkpoint. ``memory`` is the encoder's output (B, S_enc, D), which
    an encoder-decoder's cross blocks attend to."""
    remat = _remat(cfg, want_cache)
    x = constrain_bsd(embed_lookup(params["embed"], tokens, cfg.d_model))
    aux: dict = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                 for k in (_MOE_AUX if cfg.is_moe else ())}
    cache: dict = {
        "groups": {str(i): [] for i in range(len(cfg.block_pattern))},
        "tail": {},
    }
    for run in layer_runs(params, cfg):
        _, _, (section, _, _) = run[0]
        if remat and section == "groups":
            x, a = _run_checkpointed(x, run, positions, cfg, ep, memory)
            aux = _sum_aux(aux, a)
            continue
        x, entries, a = _run_layers(x, run, positions, cfg, ep, memory)
        aux = _sum_aux(aux, a)
        if not want_cache:
            continue
        for (_, _, (section, i, g)), entry in zip(run, entries):
            if g is None:
                cache[section][i] = entry
            else:
                cache[section][i].append(entry)
    if last_only:
        x = x[:, -1:]
    return _head(params, x, cfg), aux, (cache if want_cache else None)


def decode_step(
    params: Params,
    token: torch.Tensor,         # (B, 1) int
    position: torch.Tensor,      # (B, 1) or (3, B, 1)
    cache: Cache,
    cache_len: int,              # valid rows incl. this token
    cfg: ModelConfig,
    ep: EPContext = EPContext(),
) -> tuple[torch.Tensor, Cache]:
    """One token through all layers. Returns (logits (B, 1, V), cache),
    the cache dict updated in place: attention entries at row ``cache_len -
    1``, state entries with the step's new ``h`` and ``conv``."""
    x = constrain_bsd(embed_lookup(params["embed"], token, cfg.d_model))
    for kind, layer, where in layers_in_order(params, cfg):
        entry = _entry(cache, where)
        x, new = block_apply_step(layer, x, position, entry, cache_len, cfg,
                                  kind, ep)
        entry.update(new)
    return _head(params, x, cfg), cache


# --------------------------------------------------------------------------- cache init / padding


def _attn_cache_init(cfg: ModelConfig, batch: int, capacity: int, dtype,
                     device, cross_len: int = 0) -> dict:
    shape = (batch, 0, cfg.num_kv_heads, cfg.resolved_head_dim)

    def rows(shape, dtype):
        # capacity zero rows, or this rank's stripe of them (attn.striped)
        return attn.striped(torch.zeros(shape, dtype=dtype, device=device),
                            capacity)

    if cfg.kv_cache_dtype == "int8":
        # per-(token, head) symmetric scales (see attention.quantize_kv)
        scale = (batch, 0, cfg.num_kv_heads, 1)
        entry = {"self": {
            "k": rows(shape, torch.int8),
            "v": rows(shape, torch.int8),
            "k_scale": rows(scale, torch.bfloat16),
            "v_scale": rows(scale, torch.bfloat16),
        }}
    else:
        entry = {"self": {
            "k": rows(shape, dtype),
            "v": rows(shape, dtype),
        }}
    if cfg.encoder_layers > 0:
        cross = (batch, cross_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        entry["cross"] = {
            "k": torch.zeros(cross, dtype=dtype, device=device),
            "v": torch.zeros(cross, dtype=dtype, device=device),
        }
    return entry


def cache_init(cfg: ModelConfig, batch: int, capacity: int, dtype,
               device, cross_len: int = 0) -> Cache:
    """Empty cache matching decode_step's expectations; an
    encoder-decoder's attention entries hold a ``cross`` entry of
    ``cross_len`` rows. Under a split-KV mesh each self-attention leaf is
    this rank's stripe (:func:`~.attention.striped`)."""

    def entry(kind: str) -> dict:
        block_specs(cfg, kind)  # raises for an unknown kind
        if kind == "ssd":
            return ssd_cache_init(cfg, batch, dtype, device)
        if kind == "rec":
            return rglru_cache_init(cfg, batch, dtype, device)
        return _attn_cache_init(cfg, batch, capacity, dtype, device,
                                cross_len)

    return {
        "groups": {
            str(i): [entry(kind) for _ in range(cfg.group_count)]
            for i, kind in enumerate(cfg.block_pattern)
        },
        "tail": {str(i): entry(kind)
                 for i, kind in enumerate(cfg.tail_pattern)},
    }


def pad_cache_to(cache: Cache, cfg: ModelConfig, capacity: int) -> Cache:
    """Grow prefill K/V entries (length S) to ``capacity`` rows; cross
    entries and state entries, of a constant size, pass through. Under a
    split-KV mesh each self-attention leaf keeps only this rank's stripe
    of the grown rows (:func:`~.attention.striped`)."""

    def fix(entry: dict) -> dict:
        if "self" not in entry:
            return entry
        return {**entry, "self": {
            name: attn.striped(arr, capacity)
            for name, arr in entry["self"].items()
        }}

    return {
        "groups": {i: [fix(e) for e in entries]
                   for i, entries in cache["groups"].items()},
        "tail": {i: fix(e) for i, e in cache["tail"].items()},
    }
