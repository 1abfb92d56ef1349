"""Batched serving engine: prefill once, then decode token by token
(counterpart of ``repro/serve/engine.py``).

Slot-based batching: ``slots`` decode lanes; the queue is taken ``slots``
requests at a time, each batch prefilled together and decoded to its end.
Sampling is greedy (argmax, the first index on ties, as ``jnp.argmax``) or
temperature. Temperature sampling draws from a ``torch.Generator`` on the
model's device seeded with ``ServeConfig.seed`` at each ``generate`` call:
the same seed gives the same tokens in the port, but not the tokens of
``jax.random.categorical``, whose bits torch cannot reproduce.

The JAX engine jits its decode step and donates the cache; here the
prefill cache is grown once to its full capacity and each step writes its
row in place.

An encoder-decoder (seamless) is served through ``generate(prompts,
src_embeds)``, the source's frame embeddings ``(B, S_enc, d_model)`` moved
to the model's device; ``serve_queue`` passes no source, as the
reference's does, so it raises ``KeyError('src_embeds')`` for such a model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from ..models.model import ModelBundle, default_positions
from ..spans import span


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: int = -1                  # -1 => never stop early
    seed: int = 0


class ServeEngine:
    def __init__(self, bundle: ModelBundle, params,
                 cfg: ServeConfig = ServeConfig()):
        self.bundle = bundle
        self.mcfg: ModelConfig = bundle.cfg
        self.params = params
        self.cfg = cfg
        self.device = bundle.device
        got = {p.device for p in params.parameters()}
        if got != {self.device}:
            raise ValueError(f"parameters on {sorted(map(str, got))}, the "
                             f"model's device is {self.device}")

    # ------------------------------------------------------------- sampling
    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        with span("serve.sample"):
            if self.cfg.temperature <= 0:
                return logits.argmax(dim=-1).to(torch.int32)
            probs = torch.softmax(
                logits.to(torch.float32) / self.cfg.temperature, dim=-1)
            return torch.multinomial(probs, 1,
                                     generator=gen)[:, 0].to(torch.int32)

    # ------------------------------------------------------------- generate
    def generate(
        self,
        prompts: np.ndarray,             # (B, S) int32, equal length
        src_embeds=None,                 # (B, S_enc, D), encoder-decoders
        max_new_tokens: Optional[int] = None,
    ) -> np.ndarray:
        with span("serve.generate"):
            mcfg, dev = self.mcfg, self.device
            new = max_new_tokens or self.cfg.max_new_tokens
            b, s = prompts.shape
            batch = {"tokens": torch.as_tensor(
                np.ascontiguousarray(prompts, np.int32), device=dev)}
            if mcfg.rope_mode == "mrope":
                batch["positions"] = default_positions(mcfg, b, s, device=dev)
            if src_embeds is not None:
                batch["src_embeds"] = torch.as_tensor(src_embeds).to(dev)
            logits, cache = self.bundle.prefill_fn(self.params, batch)
            cache = tf.pad_cache_to(cache, mcfg, s + new)

            gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
            out = np.zeros((b, new), np.int32)
            token = self._sample(logits[:, 0], gen)
            for i in range(new):
                with span("serve.token_to_host"):
                    out[:, i] = token.cpu().numpy()
                if i == new - 1:
                    break
                pos = default_positions(mcfg, b, 1, offset=s + i, device=dev)
                logits, cache = self.bundle.decode_fn(
                    self.params, token[:, None], pos, cache, s + i + 1)
                token = self._sample(logits[:, 0], gen)
                if (self.cfg.eos_id >= 0
                        and bool((token == self.cfg.eos_id).all())):
                    out[:, i + 1:] = self.cfg.eos_id
                    break
            return out

    # ------------------------------------------------------------- continuous batching
    def serve_queue(
        self,
        requests: list[np.ndarray],      # list of (S,) prompts (equal length)
        slots: int,
        max_new_tokens: Optional[int] = None,
    ) -> list[np.ndarray]:
        """Slot-based scheduler: process ``len(requests)`` prompts through
        ``slots`` concurrent decode lanes, refilling as lanes free up."""
        results: list[Optional[np.ndarray]] = [None] * len(requests)
        queue = list(range(len(requests)))
        while queue:
            take = queue[:slots]
            queue = queue[slots:]
            prompts = np.stack([requests[i] for i in take])
            outs = self.generate(prompts, max_new_tokens=max_new_tokens)
            for j, i in enumerate(take):
                results[i] = outs[j]
        return results  # type: ignore[return-value]
