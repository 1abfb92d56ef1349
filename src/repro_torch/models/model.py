"""``build_model(cfg)`` — the port's entry point to a model (counterpart of
``repro/models/model.py``).

Returns a :class:`ModelBundle` whose functions take the parameters first,
as the JAX package's do: ``init(generator)`` gives the parameters, an
``nn.Module`` tree (:class:`~repro_torch.models.layers.ParamTree`) whose
names follow the JAX parameter tree's paths with each stacked group split
into its layers (``groups.<i>.<g>.attn.wq`` holds ``groups/<i>/attn/wq[g]``),
so :func:`~repro_torch.models.convert.params_from_jax` is a name map.

Device rule: ``build_model(cfg)`` (``device=None``) puts the model on the
CUDA card and raises without one; ``device="cpu"`` runs every kernel's
plain PyTorch version on the host.

``ep`` (:class:`~repro_torch.models.moe.EPContext`) says how the MoE
archs' expert layers run: locally (the default) or over a
``DeviceMesh``.

Training enters through ``loss_fn(params, batch)``, the reference's loss
(``repro/models/model.py:112-123``, with the MoE archs' router losses), on
parameters made with
``init(generator, trainable=True)``; it runs the same decoder as serving
with gradients on, through each kernel's ``torch.autograd.Function``
(K4 with its backward K4b, K5, K6), and with remat per scan group as the
config says. Serving's ``forward_fn``, ``prefill_fn`` and ``decode_fn``
run under ``torch.no_grad()``. :mod:`repro_torch.train` drives the loss.

For a mesh, ``axes`` is the reference parameter tree's logical axes,
``abstract()`` the same tree as meta tensors in the parameters' dtype (no
allocation), and ``cache_axes(batch, capacity, cross_len)`` the logical
axes of the port's cache tree; :class:`~repro_torch.launch.partitioning.
Partitioner` turns either into placements.

An encoder-decoder (seamless) reads its source from the batch:
``batch["src_embeds"]`` (B, S_enc, d_model), the frontend's embeddings,
cast to the compute dtype and run through the encoder, whose output every
decoder block's cross attention reads. A batch without it raises
``KeyError('src_embeds')``, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (
    implicit_replication, local_map,
)

from ..compat import SumOver, all_reduce, resolve_device, set_mesh
from ..configs.base import ModelConfig
from ..spans import span
from . import transformer as tf
from .convert import draw_into
from .layers import ParamTree, abstract_params, param_axes
from .moe import EPContext

Params = Any
Cache = Any


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def default_positions(cfg: ModelConfig, batch: int, seq: int,
                      offset: int = 0, device=None) -> torch.Tensor:
    pos = torch.arange(offset, offset + seq, dtype=torch.int32,
                       device=device)[None].expand(batch, seq)
    if cfg.rope_mode == "mrope":
        # text-stream default: t == h == w (the vision stub supplies real
        # 3D positions for patch tokens)
        return pos[None].expand(3, batch, seq)
    return pos


def _lse_gold(logits: torch.Tensor, targets: torch.Tensor, group=None,
              offset: int = 0):
    """``(logz, gold, top)`` a token in float32 from (a vocab shard of) the
    logits: the log-sum-exp, the target's logit and the largest logit.
    With ``group`` (the ranks that split the vocab, this shard starting at
    ``offset``) the shards' log-sum-exps combine as ``M + log(sum exp(lse
    - M))`` (``M`` their all-reduced max, exactly the shard's own on one
    rank), the target's logit is summed from the shard that holds it and
    the maximum all-reduced: no rank ever holds the whole vocab."""
    x = logits.to(torch.float32)
    lse = torch.logsumexp(x, dim=-1)
    top = x.amax(dim=-1)
    idx = targets.long() - offset
    inside = (idx >= 0) & (idx < x.shape[-1])
    gold = x.gather(-1, idx.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
    if group is None:
        return lse, gold, top
    gold = SumOver.apply(torch.where(inside, gold, torch.zeros_like(gold)),
                         [group], 1)
    top = all_reduce(top.detach(), "max", group)
    m = all_reduce(lse.detach(), "max", group)
    lse = m + torch.log(SumOver.apply(torch.exp(lse - m), [group], 1))
    return lse, gold, top


def _sharded_lse_gold(logits: DTensor, targets: torch.Tensor):
    """:func:`_lse_gold` on each rank's shard of DTensor logits (batch
    over the batch axes, the vocab over at most one mesh dim), through
    ``local_map``; the three results are DTensors laid out as the
    logits' batch."""
    mesh = logits.device_mesh
    vocab = [m for m, p in enumerate(logits.placements) if p == Shard(2)]
    if len(vocab) > 1 or any(p == Shard(1) for p in logits.placements):
        raise ValueError(f"cross_entropy: logits placements "
                         f"{logits.placements}; the vocab may split over "
                         "one mesh dim and the sequence over none")
    row = tuple(Replicate() if p == Shard(2) else p
                for p in logits.placements)
    group = offset = None
    if vocab:
        group = mesh.get_group(vocab[0])
        offset = mesh.get_local_rank(vocab[0]) * logits.to_local().shape[-1]
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    return local_map(
        lambda x, t: _lse_gold(x, t, group, offset or 0),
        out_placements=(row, row, row), in_placements=(logits.placements, row),
        device_mesh=mesh, redistribute_inputs=True)(logits, targets)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_weight: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL in float32, with the reference's metrics (ties
    count as correct) and optional z-loss. DTensor logits are reduced
    shard by shard (:func:`_sharded_lse_gold`)."""
    if isinstance(logits, DTensor):
        logz, gold, top = _sharded_lse_gold(logits, targets)
    else:
        logz, gold, top = _lse_gold(logits, targets)
    loss = (logz - gold).mean()
    metrics = {
        "nll": loss,
        "accuracy": (gold >= top).to(torch.float32).mean(),
    }
    if z_weight > 0:
        zl = z_weight * logz.square().mean()
        metrics["z_loss"] = zl
        loss = loss + zl
    return loss, metrics


def batch_positions(cfg: ModelConfig, tokens: torch.Tensor, device=None
                    ) -> torch.Tensor:
    """:func:`default_positions` for a batch of ``tokens``; for DTensor
    tokens, a DTensor laid out as the tokens (batch dim 1 of mrope's
    ``(3, B, S)``) whose every rank makes its own rows."""
    if not isinstance(tokens, DTensor):
        b, s = tokens.shape
        return default_positions(cfg, b, s, device=device)
    local = tokens.to_local()
    pos = default_positions(cfg, local.shape[0], local.shape[1],
                            device=local.device)
    placements = tokens.placements
    if cfg.rope_mode == "mrope":
        placements = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                      for p in placements]
    return DTensor.from_local(pos, tokens.device_mesh, placements,
                              run_check=False)


def _plain(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Serving's logits as the caller's tokens are: whole when DTensor
    parameters met plain tokens (a serving engine samples from them)."""
    if isinstance(logits, DTensor) and not isinstance(tokens, DTensor):
        return logits.full_tensor()
    return logits


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    specs: dict
    device: torch.device
    init: Callable[[torch.Generator], Params]
    skeleton: Callable[[], Params]
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    forward_fn: Callable[..., torch.Tensor]
    prefill_fn: Callable[..., tuple[torch.Tensor, Cache]]
    decode_fn: Callable[..., tuple[torch.Tensor, Cache]]
    cache_init: Callable[..., Cache]
    axes: Any = None
    cache_axes: Optional[Callable[..., Any]] = None
    abstract: Optional[Callable[[], Any]] = None
    cache_abstract: Optional[Callable[..., Any]] = None


def build_model(cfg: ModelConfig, device=None,
                ep: EPContext = EPContext()) -> ModelBundle:
    dev = resolve_device(device)
    specs = tf.decoder_specs(cfg)
    pdtype = _dtype(cfg.param_dtype)
    cdtype = _dtype(cfg.compute_dtype)

    def skeleton(trainable: bool = False) -> Params:
        """The parameter modules, uninitialised, on the device; their
        parameters require a gradient when ``trainable``."""
        return ParamTree(tf.layer_specs(cfg), pdtype, dev, trainable)

    def init(generator: torch.Generator, trainable: bool = False) -> Params:
        """Parameters drawn from ``generator`` (a generator of the
        bundle's device) by the reference's init rule, leaf by leaf into
        the skeleton (``convert.draw_into``), so that the device holds the
        model and one float32 leaf or slice at a time."""
        return draw_into(skeleton(trainable), specs, generator)

    def memory(params: Params, batch: dict) -> Optional[torch.Tensor]:
        """The encoder's output over ``batch["src_embeds"]``, or None for
        a decoder-only config (the reference's ``_memory``)."""
        if cfg.encoder_layers <= 0:
            return None
        with span("model.encoder"):
            src = torch.as_tensor(batch["src_embeds"]).to(dev, cdtype)
            return tf.encoder_apply(params["encoder"], src, cfg, ep)

    def decode_batch(params: Params, batch: dict, *, want_cache: bool = False,
                     last_only: bool = False):
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        positions = batch.get("positions")
        positions = (batch_positions(cfg, tokens, dev)
                     if positions is None else positions.to(dev))
        with implicit_replication():
            return tf.decoder_apply(params, tokens, positions, cfg, ep,
                                    memory=memory(params, batch),
                                    want_cache=want_cache,
                                    last_only=last_only)

    forward = torch.no_grad()(decode_batch)

    def loss_fn(params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token NLL of ``batch["targets"]`` and the reference's
        metrics, with gradients on; for the MoE archs plus
        ``router_aux_weight · lb / L + router_z_weight · z / L`` (the
        layers' sums over ``L = num_layers``), logged as ``moe_lb`` and
        ``moe_z``. As in the reference, the cross entropy takes no z-loss
        here (``z_weight=0.0``, whatever ``TrainConfig.z_loss`` says)."""
        logits, aux, _ = decode_batch(params, batch)
        targets = torch.as_tensor(batch["targets"]).to(dev)
        with implicit_replication():
            loss, metrics = cross_entropy(logits, targets, z_weight=0.0)
        if cfg.is_moe:
            lb = aux["lb"] / max(cfg.num_layers, 1)
            z = aux["z"] / max(cfg.num_layers, 1)
            loss = loss + cfg.router_aux_weight * lb + cfg.router_z_weight * z
            metrics["moe_lb"] = lb
            metrics["moe_z"] = z
        metrics["loss"] = loss
        return loss, metrics

    def forward_fn(params: Params, batch: dict) -> torch.Tensor:
        return _plain(forward(params, batch)[0], batch["tokens"])

    def prefill_fn(params: Params, batch: dict):
        """Process the prompt; returns (last-position logits, cache)."""
        with span("model.prefill"):
            logits, _, cache = forward(params, batch, want_cache=True,
                                       last_only=True)
            return _plain(logits, batch["tokens"]), cache

    @torch.no_grad()
    def decode_fn(params: Params, token: torch.Tensor, position: torch.Tensor,
                  cache: Cache, cache_len: int):
        with span("model.decode_step"):
            with implicit_replication():
                logits, cache = tf.decode_step(params, token.to(dev),
                                               position.to(dev), cache,
                                               int(cache_len), cfg, ep)
            return _plain(logits, token), cache

    def cache_init(batch: int, capacity: int, cross_len: int = 0) -> Cache:
        return tf.cache_init(cfg, batch, capacity, cdtype, dev, cross_len)

    def cache_abstract(batch: int, capacity: int, cross_len: int = 0) -> Any:
        """The cache tree of the global shapes as meta tensors."""
        with set_mesh(None):
            return tf.cache_init(cfg, batch, capacity, cdtype, "meta",
                                 cross_len)

    def cache_axes_fn(batch: int, capacity: int, cross_len: int = 0) -> Any:
        """Logical axes of the cache's leaves, by the reference's leaf rules
        (``repro/models/model.py:137-163``) on the port's cache tree (one
        entry a layer, so no ``layers`` axis), for the global shapes."""
        cache = cache_abstract(batch, capacity, cross_len)

        def entry_axes(entry: dict) -> dict:
            out = {}
            for key, leaf in entry.items():
                if isinstance(leaf, dict):        # "self" / "cross"
                    out[key] = {name: ("batch", "kv_seq", "kv_heads", "head")
                                for name in leaf}
                elif key == "conv":               # (B, W-1, C)
                    out[key] = ("batch", None, "ssm_inner")
                elif leaf.dim() == 4:             # ssd state (B, H, P, N)
                    out[key] = ("batch", "ssm_heads", None, None)
                else:                             # rglru state (B, W)
                    out[key] = ("batch", "lru")
            return out

        return {
            "groups": {i: [entry_axes(e) for e in entries]
                       for i, entries in cache["groups"].items()},
            "tail": {i: entry_axes(e) for i, e in cache["tail"].items()},
        }

    return ModelBundle(
        cfg=cfg, specs=specs, device=dev, init=init, skeleton=skeleton,
        loss_fn=loss_fn, forward_fn=forward_fn, prefill_fn=prefill_fn, decode_fn=decode_fn,
        cache_init=cache_init, axes=param_axes(specs), cache_axes=cache_axes_fn,
        abstract=lambda: abstract_params(specs, pdtype),
        cache_abstract=cache_abstract,
    )
