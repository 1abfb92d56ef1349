"""The training driver: the program's ``make_train_step`` step, one
object from set-up to the window.

Set-up builds the model with ``build_model``, writes the seeded weights
into its trainable parameters, makes the AdamW state (``adamw_init``) and
the step (``make_train_step``), and drives that step through the job's
``first_steps`` (each on a batch of its own drawn from the seed): they are
the warm-up, and the steps the reference follows. After the first it
reads each leaf's first gradient from the optimizer's first moment; after
the last, each leaf's change from the weights as drawn. The window then
runs the same step object on fresh batches until ``--seconds`` have
passed, each step ending in a synchronise; ``--trace 1`` adds
``trace_steps`` steps under the profiler after the window.

A batch is ``batch`` rows of ``target_tokens`` token ids drawn uniformly
from the first ``token_vocab`` ids (a byte-level corpus) with their next
tokens as targets and, for an encoder-decoder, ``source_frames`` frame
embeddings drawn from a standard normal in bfloat16 (the frontend is a
stub).
"""

from __future__ import annotations

import time

import torch

from . import compare, harness, weights
from .reference import train as ref_train
from .reference import transformer as ref
from .serve import model_config


def batch(seed: int, i: int, tr: dict, model: dict, dev: torch.device
          ) -> dict:
    """Step ``i``'s batch, drawn on the device from the seed."""
    gen = torch.Generator(device=dev).manual_seed(
        weights.leaf_seed(seed, f"traffic/batch/{i}"))
    ids = torch.randint(0, tr["token_vocab"],
                        (tr["batch"], tr["target_tokens"] + 1),
                        generator=gen, device=dev, dtype=torch.int64)
    out = {"tokens": ids[:, :-1].to(torch.int32),
           "targets": ids[:, 1:].to(torch.int32)}
    if model.get("encoder_layers", 0):
        src = torch.empty((tr["batch"], tr["source_frames"], model["d_model"]),
                          dtype=torch.bfloat16, device=dev)
        out["src_embeds"] = src.normal_(generator=gen)
    return out


def positions(tr: dict, model: dict) -> int:
    """Positions one step trains: source frames and target tokens."""
    src = tr["source_frames"] if model.get("encoder_layers", 0) else 0
    return tr["batch"] * (src + tr["target_tokens"])


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, precisions: tuple[str, ...] = ("float32",),
        window_steps=None) -> tuple:
    """One run of a training cell. Returns ``(record, readings, peak,
    the reference's outputs by precision)``; with ``"fp8"`` among the
    precisions the readings also hold the control's (``control_*``, the
    fp8 reference against the float32 one). ``window_steps`` replaces the timed window
    by that many steps (0: none)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train import TrainState, adamw_init, make_train_step

    tr, model = cell.traffic, cell.model
    dev = harness.device_of(device)
    rec = harness.Record(kind="train", cell=cell, device=device)
    tcfg = TrainConfig(**tr["train_config"])
    draw = cell.config["draw"]
    shapes = ref.parameter_shapes(model)
    pdt = getattr(torch, model["param_dtype"])

    parts = {"before": time.time() - t_start}
    t = time.perf_counter()
    bundle = build_model(model_config(model), dev)
    params = bundle.skeleton(trainable=True)
    weights.draw_into(params, seed, draw, shapes)
    state = TrainState(params, adamw_init(params, tcfg))
    step = make_train_step(bundle, tcfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["build_draw"] = time.perf_counter() - t
    t = time.perf_counter()

    prog = {"losses": []}
    for i in range(tr["first_steps"]):
        state, m = step(state, batch(seed, i, tr, model, dev))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {
                n: float(mu.to(torch.float32).norm() / (1 - tcfg.beta1))
                for n, mu in state.opt.mu.items()}
    with torch.no_grad():
        prog["update_norms"] = {
            n: float((p.to(torch.float32) - weights.drawn(
                n, shapes[n], seed, draw, pdt, dev).to(torch.float32)).norm())
            for n, p in state.params.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["first_steps"] = time.perf_counter() - t
    rec.setup_s = time.time() - t_start
    rec.extra["setup_parts"] = parts

    rec.positions = positions(tr, model)
    n = tr["first_steps"]
    t0 = time.perf_counter()
    while (len(rec.step_s) < window_steps if window_steps is not None
           else time.perf_counter() - t0 < seconds):
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.step"):
            state, _ = step(state, batch(seed, n, tr, model, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec.step_s.append(time.perf_counter() - t)
        n += 1
    rec.window_s = time.perf_counter() - t0

    if trace:
        from .trace import TracedPhase

        with TracedPhase(harness.trace_path(cell.name), dev) as phase:
            for j in range(tr["trace_steps"]):
                with torch.profiler.record_function("portbench.step"):
                    state, _ = step(state, batch(seed, n + j, tr, model, dev))
        rec.trace = phase.summary
        rec.traced_units = tr["trace_steps"]
        rec.extra["trace_parts"] = phase.parts

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, params, bundle
    harness.free(dev)

    source = weights.source(seed, draw, shapes, pdt, dev)
    batches = [batch(seed, i, tr, model, dev) for i in range(tr["first_steps"])]
    refs = {}
    t_ref = time.perf_counter()
    for prec in precisions:
        refs[prec] = ref_train.first_steps(source, model, tr["train_config"],
                                           batches, prec,
                                           tr.get("reference_rows", 0))
        harness.free(dev)
    full = compare.training(prog, refs["float32"])
    readings = {k: full[k] for k in ("loss_gap", "grad_gap", "update_gap")}
    if "fp8" in refs:
        control = compare.training(refs["fp8"], refs["float32"])
        readings.update({f"control_{k}": control[k]
                         for k in ("loss_gap", "grad_gap", "update_gap")})
    rec.extra.update(attempted=len(rec.step_s), failed=0,
                     losses=prog["losses"], leaves=full,
                     reference_s=time.perf_counter() - t_ref)
    return rec, readings, peak, refs
