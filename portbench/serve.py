"""The serving driver: a decoder-only model served through the program's
``ServeEngine.serve_queue`` in a closed loop of equal batches.

Set-up builds the model with ``build_model``, writes the seeded weights
into its parameters (:mod:`portbench.weights`), draws the prompts from the
seed and serves ``warmup_batches`` batches of the cell's own shapes, so
that every kernel is built and loaded before the window. The window then
hands the engine one batch after the other until ``--seconds`` have
passed since it began, each batch ``batch`` prompts of ``prompt_tokens``
ids with ``new_tokens`` greedy tokens to generate, all in ``slots`` lanes
at once.

The engine's ``prefill_fn`` and ``decode_fn`` are wrapped by host-clock
stamps, without changing the program: the engine moves each token to the
host just before the next ``decode_fn`` call, so the call's entry is the
time a token reached the host, and ``serve_queue``'s return the time the
last one did. In a ``--trace 1`` run the prefill is synchronised for
``prefill_ms.serve``, and ``trace_batches`` more batches run under the
profiler after the window.

Once the window has closed and the program's state is freed, a sample of
the window's batches drawn from the seed is held against the plain
reference (:func:`portbench.reference.transformer.served_logits`): for
every served token, the gap by which its logit lies below the
reference's best at that position.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import compare, harness, weights
from .reference import transformer as ref


def model_config(model: dict):
    from repro_torch.configs.base import ModelConfig

    fields = dict(model)
    for key in ("block_pattern", "mrope_sections"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return ModelConfig(**fields)


class Stamps:
    """The host-clock wrappers of a bundle's ``prefill_fn`` and
    ``decode_fn``; ``begin()`` opens a batch's record."""

    def __init__(self, bundle, sync_prefill: bool, dev: torch.device):
        self.bundle = bundle
        self.sync = sync_prefill and dev.type == "cuda"
        self.dev = dev
        self.tokens: list[float] = []
        self.prefill: Optional[float] = None

    def begin(self) -> None:
        self.tokens = []
        self.prefill = None

    def prefill_fn(self, params, batch):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.prefill"):
            out = self.bundle.prefill_fn(params, batch)
            if self.sync:
                torch.cuda.synchronize(self.dev)
        if self.sync:
            self.prefill = time.perf_counter() - t0
        return out

    def decode_fn(self, params, token, position, cache, cache_len):
        self.tokens.append(time.perf_counter())
        with torch.profiler.record_function("portbench.decode_step"):
            return self.bundle.decode_fn(params, token, position, cache,
                                         cache_len)

    def wrapped(self):
        return dataclasses.replace(self.bundle, prefill_fn=self.prefill_fn,
                                   decode_fn=self.decode_fn)


def prompts(seed: int, label: str, shape: tuple, vocab: int,
            dev: torch.device) -> np.ndarray:
    """Token ids drawn uniformly from the vocabulary on the device."""
    gen = torch.Generator(device=dev).manual_seed(
        weights.leaf_seed(seed, f"traffic/{label}"))
    ids = torch.randint(0, vocab, shape, generator=gen, device=dev,
                        dtype=torch.int64)
    return ids.to(torch.int32).cpu().numpy()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, precisions: tuple[str, ...] = ("float32",),
        window_batches: Optional[int] = None) -> tuple:
    """One run of a serving cell. Returns ``(record, readings, peak,
    served)``: the run record, each compared number, the device's peak
    bytes and the sample's served tokens. ``window_batches`` replaces the
    timed window by that many batches (a calibration's short window)."""
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    tr, model = cell.traffic, cell.model
    dev = harness.device_of(device)
    b, s, new = tr["batch"], tr["prompt_tokens"], tr["new_tokens"]
    rec = harness.Record(kind="serve", cell=cell, device=device)

    parts = {"before": time.time() - t_start}
    t = time.perf_counter()
    bundle = build_model(model_config(model), dev)
    params = bundle.skeleton()
    parts["build"] = time.perf_counter() - t
    shapes = ref.parameter_shapes(model)
    weights.draw_into(params, seed, cell.config["draw"], shapes)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["draw"] = time.perf_counter() - t - parts["build"]
    pool = prompts(seed, "prompts", (tr["pool_batches"], b, s),
                   model["vocab_size"], dev)
    warm = prompts(seed, "warmup", (tr["warmup_batches"], b, s),
                   model["vocab_size"], dev)
    stamps = Stamps(bundle, trace, dev)
    engine = ServeEngine(stamps.wrapped(), params,
                         ServeConfig(max_new_tokens=new, temperature=0.0))

    def serve(batch: np.ndarray) -> np.ndarray:
        stamps.begin()
        with torch.profiler.record_function("portbench.batch"):
            out = engine.serve_queue(list(batch), tr["slots"], new)
        stamps.tokens.append(time.perf_counter())
        return np.stack(out)

    t = time.perf_counter()
    for batch in warm:
        serve(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["warm"] = time.perf_counter() - t
    rec.setup_s = time.time() - t_start
    rec.extra["setup_parts"] = parts

    served = []
    t0 = time.perf_counter()
    while (len(served) < window_batches if window_batches is not None
           else time.perf_counter() - t0 < seconds):
        rec.batch_start.append(time.perf_counter())
        served.append(serve(pool[len(served) % len(pool)]))
        rec.token_times.append(stamps.tokens)
        if stamps.prefill is not None:
            rec.prefill_s.append(stamps.prefill)
    rec.window_s = rec.token_times[-1][-1] - t0
    rec.requests = b * len(served)
    rec.tokens = sum(int(o.shape[0] * o.shape[1]) for o in served)
    failed = sum(int(o.shape != (b, new)) * b for o in served)

    if trace:
        from .trace import TracedPhase

        with TracedPhase(harness.trace_path(cell.name), dev) as phase:
            for j in range(tr["trace_batches"]):
                serve(pool[(len(served) + j) % len(pool)])
        rec.trace = phase.summary
        rec.traced_units = tr["trace_batches"]
        rec.extra["trace_parts"] = phase.parts

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, stamps, params, bundle
    harness.free(dev)

    rng = np.random.default_rng(weights.leaf_seed(seed, "check/sample"))
    picked = sorted(rng.choice(len(served), min(tr["check_batches"],
                                                len(served)), replace=False))
    batches = [(torch.as_tensor(pool[i % len(pool)], device=dev).long(),
                torch.as_tensor(served[i], device=dev).long())
               for i in picked]
    source = weights.source(seed, cell.config["draw"], shapes,
                            getattr(torch, model["param_dtype"]), dev)
    t_ref = time.perf_counter()
    logits = ref.served_logits(source, model, batches, precisions)
    tokens = [t for _, t in batches]
    readings = compare.serving(logits, tokens)
    rec.extra.update(gaps=compare.gap_summary(logits, tokens))
    del logits
    harness.free(dev)
    rec.extra.update(attempted=rec.requests, failed=failed,
                     sample_batches=[int(i) for i in picked],
                     reference_s=time.perf_counter() - t_ref)
    return rec, readings, peak, served
