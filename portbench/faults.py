"""Faults planted in the program underneath a run, to show that the
comparison deciding ``correct`` catches them (the tests, and the
calibration's readings on the card). Each is a context manager that
patches one function of the program for as long as it is open.

- ``token_altered`` (serving): the engine's sampler returns, at the third
  token of each batch, the next id after the one it chose for the
  batch's first request;
- ``cache_unwritten`` (serving): each decode step leaves the KV cache as
  it found it (the row it wrote is zeroed again);
- ``state_unchanged`` (training): the optimizer step returns parameters
  and state unchanged;
- ``half_batch`` (training): each microbatch's gradient is the mean over
  its first half of rows, the rest left out.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def token_altered():
    from repro_torch.serve import engine

    original = engine.ServeEngine._sample
    calls = {"n": 0}

    def sample(self, logits, gen):
        token = original(self, logits, gen)
        calls["n"] += 1
        if calls["n"] % self.cfg.max_new_tokens == 3 % self.cfg.max_new_tokens:
            token = token.clone()
            token[0] = (token[0] + 1) % logits.shape[-1]
        return token

    with mock.patch.object(engine.ServeEngine, "_sample", sample):
        yield


@contextlib.contextmanager
def cache_unwritten():
    from repro_torch.models import transformer

    original = transformer.decode_step

    def decode_step(params, token, position, cache, cache_len, cfg, *a, **k):
        logits, cache = original(params, token, position, cache, cache_len,
                                 cfg, *a, **k)
        for entries in cache["groups"].values():
            for entry in entries:
                for leaf in entry["self"].values():
                    leaf[:, cache_len - 1] = 0
        return logits, cache

    with mock.patch.object(transformer, "decode_step", decode_step):
        yield


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.train import optimizer

    def adamw_update(grads, state, params, tcfg):
        return params, state, {"lr": 0.0,
                               "grad_norm": optimizer.global_norm(grads)}

    with mock.patch.object(optimizer, "adamw_update", adamw_update):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.train import train_step

    original = train_step._slice

    def _slice(batch, i, k):
        part = original(batch, i, k)
        return {key: v[:max(v.shape[0] // 2, 1)] for key, v in part.items()}

    with mock.patch.object(train_step, "_slice", _slice):
        yield


SERVING = {"token_altered": token_altered, "cache_unwritten": cache_unwritten}
TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch}
ALL = {**SERVING, **TRAINING}
