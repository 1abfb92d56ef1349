"""repro_torch.configs — the assigned architectures and shapes, a
framework-free copy of ``repro.configs`` (DESIGN.md §5)."""

from .base import ModelConfig, ShapeConfig, TrainConfig
from .registry import ARCH_IDS, all_configs, get_config
from .shapes import SHAPES, applicable

__all__ = [
    "ModelConfig", "ShapeConfig", "TrainConfig",
    "ARCH_IDS", "all_configs", "get_config", "SHAPES", "applicable",
]
