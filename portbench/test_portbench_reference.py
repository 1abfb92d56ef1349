"""The plain reference against the program at the tests' size on the CPU,
in float32 (both sides exact to rounding), and the comparison deciding
``correct`` against its control and the planted faults."""

import time

import pytest
import torch

from portbench import compare, faults, run, serve, tiny, train, weights
from portbench.reference import train as ref_train
from portbench.reference import transformer as ref

SEED = 3_000_000_019


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", tiny.names())
def test_the_layout_is_the_programs(name):
    from repro_torch.models import build_model

    c = tiny.cell(name)
    params = build_model(serve.model_config(c.model), "cpu").skeleton()
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == ref.parameter_shapes(c.model)


def test_weights_are_drawn_alike_by_name():
    a = weights.drawn("groups.0.1.attn.wq", (64, 4, 16), SEED,
                      tiny.cell(tiny.names()[0]).config["draw"],
                      torch.bfloat16, "cpu")
    b = weights.drawn("groups.0.1.attn.wq", (64, 4, 16), SEED,
                      tiny.cell(tiny.names()[0]).config["draw"],
                      torch.bfloat16, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    assert abs(float(a.float().std()) - 1 / 8) < 0.02   # 1 / sqrt(64)


def test_served_logits_are_the_programs(two_threads):
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    c = tiny.cell("dbrx_132b.serve.p2048", new_tokens=4)
    m, tr = c.model, c.traffic
    bundle = build_model(serve.model_config(m), "cpu")
    params = bundle.skeleton()
    shapes = ref.parameter_shapes(m)
    weights.draw_into(params, SEED, c.config["draw"], shapes)
    got = []

    def prefill_fn(p, batch):
        logits, cache = bundle.prefill_fn(p, batch)
        got.append(logits[:, 0])
        return logits, cache

    def decode_fn(p, token, pos, cache, n):
        logits, cache = bundle.decode_fn(p, token, pos, cache, n)
        got.append(logits[:, 0])
        return logits, cache

    import dataclasses
    engine = ServeEngine(dataclasses.replace(bundle, prefill_fn=prefill_fn,
                                             decode_fn=decode_fn), params,
                         ServeConfig(max_new_tokens=tr["new_tokens"]))
    prompts = serve.prompts(SEED, "prompts", (tr["batch"], tr["prompt_tokens"]),
                            m["vocab_size"], torch.device("cpu"))
    served = engine.generate(prompts)
    want = ref.served_logits(
        weights.source(SEED, c.config["draw"], shapes, torch.float32, "cpu"),
        m, [(torch.as_tensor(prompts).long(), torch.as_tensor(served).long())])
    program = torch.stack(got, dim=1)
    torch.testing.assert_close(program, want["float32"][0], atol=1e-4,
                               rtol=1e-4)
    readings = compare.serving(want, [torch.as_tensor(served).long()])
    assert readings["logit_gap"] < 1e-4


def test_training_steps_are_the_programs(two_threads):
    c = tiny.cell("seamless_m4t_medium.train.s2048")
    rec, readings, _, refs = train.run(c, SEED, 0.0, False, "cpu", time.time(),
                                       window_steps=0)
    assert readings["loss_gap"] < 1e-5
    assert readings["grad_gap"] < 1e-4
    assert readings["update_gap"] < 1e-3
    losses = refs["float32"]["losses"]
    assert len(losses) == c.traffic["first_steps"] == len(rec.extra["losses"])


def test_the_learning_rate_is_the_programs():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import lr_schedule

    tc = tiny.cell("seamless_m4t_medium.train.s2048").traffic["train_config"]
    program = lr_schedule(TrainConfig(**tc))
    for step in (1, 2, 3, 5, 8, 20):
        assert abs(float(program(torch.tensor(step)))
                   - ref_train.learning_rate(step, tc)) < 1e-10


#: the serving control's size: the cell's own depth and a vocabulary wide
#: enough that the top logits lie as close as the cell's do
CONTROL_MODEL = dict(num_layers=8, d_model=256, d_ff=512, vocab_size=32768)


@pytest.mark.parametrize("name", tiny.names())
def test_the_control_is_not_correct(name, two_threads):
    """The reference in fp8, in the program's place, fails the cell's
    limits (at a size the tests can run, over a larger sample)."""
    c = tiny.cell(name, CONTROL_MODEL, prompt_tokens=32, check_batches=4) \
        if "serve" in name else tiny.cell(name)
    driver = serve if "serve" in name else train
    short = ({"window_batches": 4} if "serve" in name
             else {"window_steps": 0})
    _, readings, _, _ = driver.run(c, SEED, 0.0, False, "cpu", time.time(),
                                   ("float32", "fp8"), **short)
    control = {k[len("control_"):]: v for k, v in readings.items()
               if k.startswith("control_")}
    assert any(control[k] > lim["limit"]
               for k, lim in c.limits["checks"].items()), (control, c.limits)


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in tiny.names()
    for f in (faults.SERVING if "serve" in n else faults.TRAINING)])
def test_a_fault_underneath_makes_the_run_not_correct(name, fault,
                                                      two_threads):
    c = tiny.cell(name)
    with faults.ALL[fault]():
        res = run.execute(c, SEED, 0.3, False, "cpu", time.time())
    assert res["correct"] is False, res["checks"]
