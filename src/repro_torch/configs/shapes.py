"""The assigned input-shape suite (identical across the LM pool).

``decode_*`` / ``long_*`` lower `serve_step` (one new token against a
seq_len KV cache); ``prefill_*`` lowers the prefill step; ``train_*``
lowers `train_step`. `long_500k` requires a sub-quadratic stack — see
`applicable()` and DESIGN.md §5 for the skip rule.
"""

from __future__ import annotations

from .base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} has full-attention global layers (skip per assignment)"
        )
    return True, ""
