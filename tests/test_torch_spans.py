"""The port's profiler spans (``repro_torch.spans``): a shared no-op when
nothing records, the layer boundaries' names and nesting under
``torch.profiler``, and no change to what the program computes."""

import ast
import contextlib
import copy
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import TrainState, adamw_init, make_train_step
from torch_ranks import run_ranks

PORT = pathlib.Path(spans.__file__).resolve().parent

#: every span the program opens (PERF.md section 3 names what reads each)
TABLE = {
    "serve.generate", "serve.sample", "serve.token_to_host",
    "model.prefill", "model.decode_step", "model.encoder", "model.head",
    "block.attention", "block.mlp",
    "moe", "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
    "moe.aux", "moe.all_to_all",
    "train.step", "train.forward", "train.backward", "train.accumulate",
    "train.optimizer",
}
MOE = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.aux"}
SERVE = {"serve.generate", "serve.sample", "serve.token_to_host",
         "model.prefill", "model.decode_step", "model.head",
         "block.attention"}
TRAIN = {"train.step", "train.forward", "train.backward", "train.accumulate",
         "train.optimizer", "model.head", "block.attention"}
EXPECTED = {
    "moe_serve": SERVE | MOE | {"moe"},
    "moe_train": TRAIN | MOE | {"moe"},
    "encdec_serve": SERVE | {"model.encoder", "block.mlp"},
    "encdec_train": TRAIN | {"model.encoder", "block.mlp"},
}
A2A = MOE | {"moe.all_to_all"}


def _model(kind: str):
    arch = "dbrx_132b" if kind == "moe" else "seamless_m4t_medium"
    bundle = build_model(get_config(arch).reduce(), "cpu")
    return bundle, bundle.init(torch.Generator().manual_seed(0),
                               trainable=True)


def _serve(kind: str, bundle, params) -> np.ndarray:
    engine = ServeEngine(bundle, params, ServeConfig(max_new_tokens=3))
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8), np.int32)
    with torch.no_grad():
        if kind == "moe":
            return np.stack(engine.serve_queue(list(prompts), 2, 3))
        src = torch.from_numpy(np.random.default_rng(2).normal(
            size=(2, 12, bundle.cfg.d_model)).astype(np.float32))
        return engine.generate(prompts, src)


def _train(bundle, params):
    """One two-microbatch step from ``params``: ``(loss, state after)``."""
    tcfg = TrainConfig(microbatches=2, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (4, 8),
                                                     np.int32)),
             "targets": torch.from_numpy(rng.integers(0, 512, (4, 8),
                                                      np.int32))}
    if bundle.cfg.encoder_layers:
        batch["src_embeds"] = torch.from_numpy(rng.normal(
            size=(4, 12, bundle.cfg.d_model)).astype(np.float32))
    state = TrainState(params, adamw_init(params, tcfg))
    state, metrics = make_train_step(bundle, tcfg)(state, batch)
    return metrics["loss"], state


def _run(case: str, bundle, params):
    kind, what = case.split("_")
    if what == "serve":
        return _serve(kind, bundle, params)
    return _train(bundle, params)


def _program_spans(prof) -> list:
    """``(name, enclosing span names, innermost first)`` of every program
    span the profiler recorded."""
    out = []
    for e in prof.events():
        if not e.name.startswith(spans.PREFIX):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(spans.PREFIX):
                up.append(p.name[len(spans.PREFIX):])
            p = p.cpu_parent
        out.append((e.name[len(spans.PREFIX):], up))
    return out


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _program_spans(prof)


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = spans.span("moe.route"), spans.span("train.step")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass
    # the whole serving and training paths enter none either
    bundle, params = _model("moe")
    assert _serve("moe", bundle, params).shape == (2, 3)
    loss, _ = _train(bundle, params)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_the_profiler_records_the_layer_spans_nested(case):
    bundle, params = _model(case.split("_")[0])
    _, recorded = _profiled(lambda: _run(case, bundle, params))
    assert {name for name, _ in recorded} == EXPECTED[case]
    steps = {"model.prefill", "model.decode_step", "train.forward",
             "train.backward"}
    for name, up in recorded:
        if name in MOE:
            assert up[0] == "moe", (name, up)
        if name in ("moe", "model.head", "block.attention", "block.mlp",
                    "model.encoder"):
            assert steps & set(up), (name, up)
        if name.startswith("serve.") and name != "serve.generate":
            assert up == ["serve.generate"], (name, up)
        if name in ("model.prefill", "model.decode_step"):
            assert up == ["serve.generate"], (name, up)
        if name.startswith("train.") and name != "train.step":
            assert up == ["train.step"], (name, up)
    if case == "moe_serve":
        counts = {n: sum(1 for m, _ in recorded if m == n)
                  for n in ("model.prefill", "model.decode_step",
                            "serve.token_to_host", "moe.experts")}
        # 3 tokens a request: one prefill, two decode steps, 2 layers
        assert counts == {"model.prefill": 1, "model.decode_step": 2,
                          "serve.token_to_host": 3, "moe.experts": 6}


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_spans_change_no_token_loss_or_weight(case):
    bundle, params = _model(case.split("_")[0])
    twin = copy.deepcopy(params)
    plain = _run(case, bundle, params)
    traced, _ = _profiled(lambda: _run(case, bundle, twin))
    if case.endswith("serve"):
        assert np.array_equal(plain, traced)
        return
    (loss, state), (loss_t, state_t) = plain, traced
    assert torch.equal(loss, loss_t)
    for (name, p), (_, q) in zip(state.params.named_parameters(),
                                 state_t.params.named_parameters()):
        assert torch.equal(p, q), name
    for tree in ("mu", "nu"):
        for name, m in getattr(state.opt, tree).items():
            assert torch.equal(m, getattr(state_t.opt, tree)[name]), name


A2A_SCRIPT = r"""
import dataclasses
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch.partitioning import Partitioner, shard_tensor
from repro_torch.models.layers import init_params
from repro_torch.models.moe import EPContext, moe_apply, moe_specs

mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(
    get_config("dbrx_132b").reduce(num_experts=4, top_k=2, d_model=32,
                                   d_ff=64, vocab_size=128),
    moe_layout="a2a", capacity_factor=8.0)
specs = moe_specs(cfg)
part = Partitioner(mesh)
full = init_params(specs, torch.Generator().manual_seed(0), torch.float32,
                   "cpu")
params = {k: shard_tensor(v, part.sharding(v.shape, specs[k].axes))
          for k, v in full.items()}
x = torch.randn(4, 8, 32, generator=torch.Generator().manual_seed(1))
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    y, _ = moe_apply(params, x, cfg, EPContext(mesh=mesh))
names = sorted({e.name[len(spans.PREFIX):] for e in prof.events()
                if e.name.startswith(spans.PREFIX)})
plain, _ = moe_apply(params, x, cfg, EPContext(mesh=mesh))
np.savez(OUT, names=np.array(names), same=np.array(torch.equal(y, plain)))
"""


def test_the_all_to_all_path_records_its_wire(tmp_path):
    ranks = run_ranks(tmp_path, 2, A2A_SCRIPT, {})
    for out in ranks:
        assert set(out["names"].tolist()) == A2A
        assert bool(out["same"])


def test_the_spans_in_the_code_are_the_table():
    """Every ``span("<name>")`` under ``src/repro_torch/``, and no other
    name; the tests above record each of them."""
    found = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "span"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (path, node.lineno)
                found.add(arg.value)
    assert found == TABLE
    assert set().union(*EXPECTED.values(), A2A) == TABLE


def test_a_span_is_the_profilers_range_while_it_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("model.head"):
            torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert "repro_torch.model.head" in names
    assert spans.span("model.head") is spans.span("moe")  # off again


def test_the_smoke_breakdown_leaves_out_the_spans_device_copies():
    """While a span is open on the card the profiler records it once more
    on the device's timeline, as a CUDA event that covers the kernels
    launched inside it; ``chip_smoke.device_events`` keeps the work and
    not those copies."""
    import importlib.util
    import types

    path = PORT.parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_spans", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device,
                                     is_user_annotation=annotation)

    events = [event("repro_torch.train.step", cpu, True),
              event("aten::mm", cpu),
              event("repro_torch.train.step", cuda, True),
              event("repro_torch.block.attention", cuda, True),
              event("nvjet_tst_128x128", cuda),
              event("Memcpy HtoD (Pageable -> Device)", cuda)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in smoke.device_events(prof)] == [
        "nvjet_tst_128x128", "Memcpy HtoD (Pageable -> Device)"]
