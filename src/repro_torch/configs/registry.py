"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = (
    "arctic_480b",
    "dbrx_132b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
    "gemma2_2b",
    "qwen3_8b",
    "chatglm3_6b",
    "granite_3_2b",
    "qwen2_vl_7b",
    "mamba2_1_3b",
)


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
