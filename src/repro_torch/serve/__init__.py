"""repro_torch.serve — batched prefill/decode serving."""

from .engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
