"""repro_torch.models — the serving and training paths' models
(counterpart of ``repro.models``): decoders of ``attn`` / ``local_attn``
blocks, whose sequence attention runs through the flash-attention kernel
K4 (and its backward K4b), of ``ssd``
(Mamba-2) blocks, whose mixer runs through the chunked SSD kernel K5, and
of ``rec`` (RG-LRU) blocks, whose recurrence runs through the scan kernel
K6."""

from .convert import params_from_jax
from .model import ModelBundle, build_model, cross_entropy, default_positions

__all__ = [
    "ModelBundle", "build_model", "cross_entropy", "default_positions",
    "params_from_jax",
]
