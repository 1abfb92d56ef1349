"""The port's optimizer, train step and trainer against the JAX package on
the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
model's parameters reach the port through ``params_from_jax``. Tolerances:
the schedule and one AdamW step in float32 at 1e-6 relative (float32
``pow``/``cos``/``sqrt`` of the two libraries may land an ulp apart);
bfloat16 moments at one bf16 unit (2^-8 relative: a float32 value an ulp
apart may round to the neighbouring bf16); one train step on the reduced
granite, per leaf: the first moment (the gradient, scaled) within 1e-4
in relative L2 (the gradients agree to about 4e-5; single elements where
large terms cancel, such as a tied embedding's, differ by more), the
update ``p' - p`` within 1e-4 in relative L2 where the gradient is well
above Adam's epsilon (``|g| > 1e-6``), and every parameter within the
step's learning rate: the first step moves an element by ``lr g / (|g| +
1e-8)``, so a float32 difference in a gradient near 1e-8 moves it by up to
``lr``; the loss and metrics at 1e-5. The
counterparts of ``tests/test_train.py:30,42,55,62,71,91`` keep their
bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.train import optimizer as jopt
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import HostBatcher
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import (
    FailurePlan, Trainer, TrainerConfig, init_train_state, make_eval_step,
    make_train_step, run_with_restarts,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import reference_layout
from repro_torch.train.train_step import TrainState

F32 = dict(atol=0.0, rtol=1e-6)
BF16_UNIT = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}


# --------------------------------------------------------------------------- optimizer


def test_lr_schedule_matches_the_reference_at_every_step():
    kw = dict(learning_rate=1e-3, warmup_steps=3, total_steps=12)
    want = jopt.lr_schedule(JaxTrainConfig(**kw))
    got = opt.lr_schedule(TrainConfig(**kw))
    for step in range(0, 15):
        np.testing.assert_allclose(
            _np(got(torch.tensor(step, dtype=torch.int32))),
            np.asarray(want(jnp.int32(step))), **F32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(state_dtype):
    rng = np.random.default_rng(0)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              opt_state_dtype=state_dtype, grad_clip=2.0)
    params, grads = _tree(rng, SHAPES), _tree(rng, SHAPES)
    mu = _tree(rng, SHAPES)
    nu = {k: np.abs(v) for k, v in _tree(rng, SHAPES).items()}
    jdt = jnp.dtype(state_dtype)
    jstate = jopt.OptState(step=jnp.int32(3),
                           mu={k: jnp.asarray(v, jdt) for k, v in mu.items()},
                           nu={k: jnp.asarray(v, jdt) for k, v in nu.items()},
                           residual=None)
    jp, js, jm = jopt.adamw_update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
        {k: jnp.asarray(v) for k, v in params.items()}, JaxTrainConfig(**kw))
    tdt = getattr(torch, state_dtype)
    pstate = opt.OptState(step=torch.tensor(3, dtype=torch.int32),
                          mu={k: _t(v).to(tdt) for k, v in mu.items()},
                          nu={k: _t(v).to(tdt) for k, v in nu.items()},
                          residual=None)
    pp, ps, pm = opt.adamw_update({k: _t(v) for k, v in grads.items()},
                                  pstate, {k: _t(v) for k, v in params.items()},
                                  TrainConfig(**kw))
    assert int(ps.step) == int(js.step) == 4
    np.testing.assert_allclose(_np(pm["lr"]), np.asarray(jm["lr"]), **F32)
    np.testing.assert_allclose(_np(pm["grad_norm"]),
                               np.asarray(jm["grad_norm"]), **F32)
    state_tol = F32 if state_dtype == "float32" else dict(atol=0.0,
                                                         rtol=BF16_UNIT)
    for k in SHAPES:
        np.testing.assert_allclose(_np(pp[k]), np.asarray(jp[k]),
                                   atol=1e-7, rtol=1e-6)
        assert ps.mu[k].dtype == tdt
        np.testing.assert_allclose(_np(ps.mu[k]), _np(np.asarray(
            js.mu[k], np.float32)), **state_tol)
        np.testing.assert_allclose(_np(ps.nu[k]), _np(np.asarray(
            js.nu[k], np.float32)), **state_tol)


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    grads = {k: v * 10 for k, v in _tree(rng, SHAPES).items()}
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.5)
    pc, pn = opt.clip_by_global_norm({k: _t(v) for k, v in grads.items()}, 1.5)
    np.testing.assert_allclose(_np(pn), np.asarray(jn), **F32)
    for k in SHAPES:
        np.testing.assert_allclose(_np(pc[k]), np.asarray(jc[k]), **F32)


def test_grad_clip_and_norm():
    """``tests/test_train.py:55``."""
    g = {"w": torch.full((4,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_lr_schedule_shape():
    """``tests/test_train.py:62``."""
    lr = opt.lr_schedule(TrainConfig(learning_rate=1e-3, warmup_steps=10,
                                     total_steps=100))
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3)
    assert float(lr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)
    assert float(lr(torch.tensor(55))) < 1e-3


def test_quantize_grads_with_feedback_matches_the_reference():
    rng = np.random.default_rng(2)
    grads, resid = _tree(rng, SHAPES), _tree(rng, SHAPES)
    resid = {k: v * 0.01 for k, v in resid.items()}
    jq, js, jr = jopt.quantize_grads_with_feedback(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in resid.items()})
    pq, ps, pr = opt.quantize_grads_with_feedback(
        {k: _t(v) for k, v in grads.items()},
        {k: _t(v) for k, v in resid.items()})
    deq = opt.dequantize_grads(pq, ps, pq)
    jdeq = jopt.dequantize_grads(jq, js, jq)
    for k in SHAPES:
        assert pq[k].dtype == torch.int8
        np.testing.assert_array_equal(pq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(_np(ps[k]), np.asarray(js[k]), **F32)
        np.testing.assert_allclose(_np(pr[k]), np.asarray(jr[k]),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(_np(deq[k]), np.asarray(jdeq[k]), **F32)


def test_quantize_error_feedback_converges():
    """``tests/test_train.py:71``: int8 + error feedback, the mean
    quantized signal tends to the true signal."""
    rng = np.random.default_rng(0)
    g_true = _t(rng.normal(size=(256,)).astype(np.float32))
    resid = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    n = 64
    for _ in range(n):
        q, s, r = opt.quantize_grads_with_feedback({"g": g_true}, {"g": resid})
        resid = r["g"]
        acc = acc + q["g"].to(torch.float32) * s["g"]
    err = float((acc / n - g_true).abs().max())
    nq, ns = opt.quantize_tensor(g_true)
    naive_err = float((nq.to(torch.float32) * ns - g_true).abs().max())
    assert err < naive_err / 3
    assert err < 2e-3


# --------------------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def tiny():
    """The reduced granite in both packages, the same parameters, and a
    batch (``tests/test_train.py:20``)."""
    jcfg = jax_config("granite_3_2b").reduce()
    jb = jax_build(jcfg)
    jparams = jb.init(jax.random.key(0))
    pb = build_model(get_config("granite_3_2b").reduce(), "cpu")
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32),
        "targets": rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32),
    }
    return jb, jparams, pb, batch


def _port_state(pb, jparams, tcfg):
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            pb.skeleton(trainable=True))
    return TrainState(model, opt.adamw_init(model, tcfg))


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _stacked(model) -> dict:
    return {k: (torch.stack(ts) if st else ts[0]).detach().numpy()
            for k, (ts, st) in reference_layout(model).items()}


def _jax_flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_the_reference(tiny, microbatches):
    jb, jparams, pb, batch = tiny
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
              microbatches=microbatches)
    jstate = JaxTrainState(jparams, jopt.adamw_init(jparams, JaxTrainConfig(**kw)))
    jstate, jm = jax.jit(jax_make_train_step(jb, JaxTrainConfig(**kw)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = TrainConfig(**kw)
    state = _port_state(pb, jparams, tcfg)
    state, m = make_train_step(pb, tcfg)(state, _port_batch(batch))
    assert set(m) == set(jm)
    for k in ("loss", "nll", "accuracy", "lr"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(_np(m["grad_norm"]), np.asarray(jm["grad_norm"]),
                               rtol=1e-4)
    before = _jax_flat(jparams)
    got, want = _stacked(state.params), _jax_flat(jstate.params)
    mu, jmu = _stacked(state.opt.mu), _jax_flat(jstate.opt.mu)
    assert set(got) == set(want) == set(mu) == set(jmu)
    lr = float(jm["lr"])
    for k in want:
        assert _rel_l2(mu[k], jmu[k]) < 1e-4, k
        firm = np.abs(jmu[k]) > (1 - 0.9) * 1e-6      # mu = (1 - b1) g
        assert _rel_l2((got[k] - before[k])[firm],
                       (want[k] - before[k])[firm]) < 1e-4, k
        np.testing.assert_allclose(got[k], want[k], atol=lr, rtol=0,
                                   err_msg=k)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_loss_decreases_on_fixed_batch(tiny):
    """``tests/test_train.py:30``."""
    _, jparams, pb, batch = tiny
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=40)
    state = _port_state(pb, jparams, tcfg)
    step = make_train_step(pb, tcfg)
    first = None
    for _ in range(25):
        state, m = step(state, _port_batch(batch))
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first - 0.5


def test_microbatch_accumulation_equivalence(tiny):
    """``tests/test_train.py:42``."""
    _, jparams, pb, batch = tiny
    t1 = TrainConfig(learning_rate=1e-3, microbatches=1)
    t4 = TrainConfig(learning_rate=1e-3, microbatches=4)
    s1, _ = make_train_step(pb, t1)(_port_state(pb, jparams, t1),
                                    _port_batch(batch))
    s4, _ = make_train_step(pb, t4)(_port_state(pb, jparams, t4),
                                    _port_batch(batch))
    for (n, a), (_, b) in zip(s1.params.named_parameters(),
                              s4.params.named_parameters()):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-4,
                                   err_msg=n)


def test_bf16_opt_state_dtype(tiny):
    """``tests/test_train.py:91``."""
    _, jparams, pb, batch = tiny
    tcfg = TrainConfig(opt_state_dtype="bfloat16")
    state = init_train_state(pb, tcfg, torch.Generator().manual_seed(0))
    assert next(iter(state.opt.mu.values())).dtype == torch.bfloat16
    state, m = make_train_step(pb, tcfg)(state, _port_batch(batch))
    assert bool(torch.isfinite(m["loss"]))
    assert next(iter(state.opt.nu.values())).dtype == torch.bfloat16


def test_eval_step_and_the_mesh_refusal(tiny):
    _, jparams, pb, batch = tiny
    state = _port_state(pb, jparams, TrainConfig())
    m = make_eval_step(pb)(state.params, _port_batch(batch))
    loss, _ = pb.loss_fn(state.params, _port_batch(batch))
    assert float(m["loss"]) == float(loss.detach())
    assert not m["loss"].requires_grad
    # the layout pin (grad_shardings=) needs a mesh; on one, the step
    # refuses a state that is not in the rules' layout
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(pb, TrainConfig(grad_compression="int8"),
                        pod_axis="pod", grad_shardings={})
    from repro_torch.launch import make_test_mesh

    mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    try:
        with pytest.raises(TypeError, match="shard_train_state"):
            make_train_step(pb, TrainConfig(), mesh=mesh)(
                state, _port_batch(batch))
    finally:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------- trainer


def _batcher(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, vocab, 4000).astype(np.int32) for _ in range(2)]
    return HostBatcher(shards, batch_size=4, seq_len=16)


def test_crash_and_restart_end_bit_identical(tmp_path):
    """The exact-resume contract (``repro/train/checkpoint.py:6-7``): a run
    crashed at step 3 and restarted from its step-2 checkpoint ends with the
    parameters and moments of an uninterrupted run, bit for bit."""
    pb = build_model(get_config("gemma2_2b").reduce(), "cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6,
                       microbatches=2)
    logs = []

    def trainer(name, plan=None):
        return Trainer(pb, tcfg, _batcher(pb.cfg.vocab_size),
                       TrainerConfig(ckpt_dir=str(tmp_path / name),
                                     ckpt_every=2, log_every=1),
                       failure_plan=plan, log_fn=logs.append)

    straight = trainer("straight")
    assert straight.run(6).final_step == 6
    crashed = trainer("crashed", FailurePlan(crash_at_steps=(3,)))
    final, restarts = run_with_restarts(lambda: crashed.run(6).final_step)
    assert (final, restarts) == (6, 1)
    assert "[trainer] resumed from step 2" in logs

    def final_state(name):
        state = init_train_state(pb, tcfg, torch.Generator().manual_seed(5))
        from repro_torch.train import load_checkpoint
        load_checkpoint(tmp_path / name, {"params": state.params,
                                          "opt": state.opt})
        return state

    a, b = final_state("straight"), final_state("crashed")
    assert int(a.step) == int(b.step) == 6
    for (n, x), (_, y) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(x, y), n
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], b.opt.mu[k])
        assert torch.equal(a.opt.nu[k], b.opt.nu[k])


def test_trainer_preemption_checkpoints_then_resumes(tmp_path):
    pb = build_model(get_config("granite_3_2b").reduce(), "cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    logs = []
    tr = Trainer(pb, tcfg, _batcher(pb.cfg.vocab_size),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10,
                               log_every=1, keep_last=1),
                 failure_plan=FailurePlan(preempt_at_steps=(2,)),
                 log_fn=logs.append)
    final, restarts = run_with_restarts(lambda: tr.run(4).final_step)
    assert (final, restarts) == (4, 1)
    assert "[trainer] resumed from step 2" in logs
    # keep_last=1: only the final step's checkpoint is left
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004"]
    report = tr.run(4)
    assert report.final_step == 4 and report.losses == []


def test_train_config_is_the_reference_dataclass():
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JaxTrainConfig)]
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(JaxTrainConfig()))
