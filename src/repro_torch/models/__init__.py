"""repro_torch.models — the serving and training paths' models
(counterpart of ``repro.models``): decoders of ``attn`` / ``local_attn``
blocks, whose sequence attention runs through the flash-attention kernel
K4 (and its backward K4b), of ``ssd``
(Mamba-2) blocks, whose mixer runs through the chunked SSD kernel K5, and
of ``rec`` (RG-LRU) blocks, whose recurrence runs through the scan kernel
K6; the MoE archs' attention blocks take a mixture-of-experts FFN
(:mod:`.moe`, local or expert-parallel through ``EPContext``)."""

from .convert import params_from_jax
from .model import ModelBundle, build_model, cross_entropy, default_positions
from .moe import EPContext

__all__ = [
    "EPContext", "ModelBundle", "build_model", "cross_entropy",
    "default_positions", "params_from_jax",
]
