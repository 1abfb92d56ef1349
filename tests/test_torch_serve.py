"""The port's serving engine and launcher on the CPU: the invariants of
``tests/test_serve.py`` (greedy determinism, batch-order invariance,
``serve_queue`` equal to ``generate``, temperature seeds that differ), and
greedy tokens equal to the reference engine's on the same parameters, for
a dense arch, for the two state-space families (RG-LRU with local
attention, Mamba-2 SSD), whose caches carry a recurrent state, and for the
two MoE archs. Batch-order invariance is not asked of the MoE archs: the
experts' capacity couples a batch's rows, in the reference too.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_tf
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.model import default_positions as jax_positions
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServeConfig, ServeEngine

ARCH = "granite_3_2b"
STATE = ["recurrentgemma_2b", "mamba2_1_3b"]
MOE = ["dbrx_132b", "arctic_480b"]
# the reference's decode band (tests/test_decode_equivalence.py)
ATOL, RTOL = 3e-4, 1e-3


@pytest.fixture(scope="module")
def models():
    jb = jax_build(jax_config(ARCH).reduce())
    params = jb.init(jax.random.key(0))
    pb = build_model(get_config(ARCH).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), pb.skeleton())
    return jb, params, pb, model


@pytest.fixture(scope="module")
def engine(models):
    _, _, pb, model = models
    return ServeEngine(pb, model, ServeConfig(max_new_tokens=6))


def test_greedy_deterministic(engine):
    prompts = np.ones((2, 8), np.int32) * 5
    a = engine.generate(prompts)
    b = engine.generate(prompts)
    assert a.shape == (2, 6)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and (a >= 0).all()


def test_batch_order_invariance(engine):
    """Each slot decodes independently: swapping batch rows swaps outputs."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 100, (2, 8)).astype(np.int32)
    out = engine.generate(prompts)
    flipped = engine.generate(prompts[::-1])
    np.testing.assert_array_equal(out, flipped[::-1])


def test_serve_queue_slots(engine):
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, 100, (8,)).astype(np.int32) for _ in range(5)]
    outs = engine.serve_queue(reqs, slots=2, max_new_tokens=4)
    assert len(outs) == 5 and all(o.shape == (4,) for o in outs)
    direct = engine.generate(reqs[3][None], max_new_tokens=4)[0]
    np.testing.assert_array_equal(outs[3], direct)


def test_temperature_sampling_varies_with_the_seed(models):
    _, _, pb, model = models
    p = np.ones((1, 6), np.int32)
    outs = [ServeEngine(pb, model, ServeConfig(
        max_new_tokens=8, temperature=1.5, seed=seed)).generate(p)
        for seed in (1, 2, 1)]
    assert not np.array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_eos_stops_early(models):
    """As the reference: after each decode step, a batch whose tokens all
    equal ``eos_id`` stops and the rest of its row is ``eos_id`` (the first
    token, from the prefill, is not checked)."""
    _, _, pb, model = models
    prompts = np.ones((1, 8), np.int32) * 5
    free = ServeEngine(pb, model, ServeConfig(max_new_tokens=6)).generate(
        prompts)[0]
    eos = int(free[2])
    stop = next(j for j in range(1, 6) if free[j] == eos)
    want = np.concatenate([free[:stop], np.full(6 - stop, eos)])
    out = ServeEngine(pb, model, ServeConfig(
        max_new_tokens=6, eos_id=eos)).generate(prompts)
    np.testing.assert_array_equal(out[0], want)


def _greedy_against_the_reference(jb, params, pb, model, prompts, new):
    """Greedy tokens of both engines. Equal tokens follow from equal logits
    only where the top two logits are further apart than the band, so that
    margin is asserted at every step (on the reference's teacher-forced
    logits), not assumed."""
    want = JaxServeEngine(jb, params, JaxServeConfig(
        max_new_tokens=new)).generate(prompts)
    got = ServeEngine(pb, model, ServeConfig(max_new_tokens=new)).generate(
        prompts)
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    logits = np.asarray(jb.forward_fn(params, {"tokens": jnp.asarray(seq)}))
    steps = logits[:, prompts.shape[1] - 1:]            # (B, new, V)
    top2 = np.sort(steps, axis=-1)[..., -2:]
    band = 2 * (ATOL + RTOL * np.abs(top2[..., 1]))
    assert (top2[..., 1] - top2[..., 0] > band).all(), \
        float((top2[..., 1] - top2[..., 0] - band).min())
    np.testing.assert_array_equal(steps.argmax(-1), want)
    np.testing.assert_array_equal(got, want)


def test_greedy_tokens_equal_the_reference_engine(models):
    jb, params, pb, model = models
    # the reference's greedy input (tests/test_serve.py::
    # test_greedy_deterministic)
    _greedy_against_the_reference(jb, params, pb, model,
                                  np.ones((2, 8), np.int32) * 5, new=6)


@pytest.mark.parametrize("arch", STATE)
def test_greedy_tokens_of_the_state_archs_equal_the_reference_engine(arch):
    """Prompts past mamba2's reduced chunk (8) and recurrentgemma's reduced
    window (32), so that the prefill hands a state carried across chunks
    and a windowed cache to the decode."""
    jb = jax_build(jax_config(arch).reduce())
    params = jb.init(jax.random.key(0))
    pb = build_model(get_config(arch).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), pb.skeleton())
    prompts = np.random.default_rng(2).integers(
        0, pb.cfg.vocab_size, (2, 45)).astype(np.int32)
    _greedy_against_the_reference(jb, params, pb, model, prompts, new=6)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_of_the_moe_archs_equal_the_reference_engine(arch):
    """The margin is read on the reference's own prefill and teacher-forced
    decode logits, which route as the engine does (the forward pass over
    prompt and tokens routes ``B·S`` tokens at a time, with another
    capacity, so it may drop other pairs)."""
    jb = jax_build(jax_config(arch).reduce())
    params = jb.init(jax.random.key(0))
    pb = build_model(get_config(arch).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), pb.skeleton())
    prompts = np.random.default_rng(2).integers(
        0, pb.cfg.vocab_size, (2, 45)).astype(np.int32)
    new = 6
    want = JaxServeEngine(jb, params, JaxServeConfig(
        max_new_tokens=new)).generate(prompts)
    got = ServeEngine(pb, model, ServeConfig(max_new_tokens=new)).generate(
        prompts)
    b, s = prompts.shape
    logits, cache = jb.prefill_fn(params, {"tokens": jnp.asarray(prompts)})
    cache = jax_tf.pad_cache_to(cache, jb.cfg, s + new)
    steps = [np.asarray(logits[:, 0])]
    for i in range(new - 1):
        logits, cache = jb.decode_fn(
            params, jnp.asarray(want[:, i:i + 1]),
            jax_positions(jb.cfg, b, 1, offset=s + i), cache,
            jnp.int32(s + i + 1))
        steps.append(np.asarray(logits[:, 0]))
    steps = np.stack(steps, axis=1)                      # (B, new, V)
    top2 = np.sort(steps, axis=-1)[..., -2:]
    band = 2 * (ATOL + RTOL * np.abs(top2[..., 1]))
    assert (top2[..., 1] - top2[..., 0] > band).all(), \
        float((top2[..., 1] - top2[..., 0] - band).min())
    np.testing.assert_array_equal(steps.argmax(-1), want)
    np.testing.assert_array_equal(got, want)


def test_engine_refuses_parameters_on_another_device(models):
    _, _, pb, model = models
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    meta = pb.skeleton().to("meta")
    with pytest.raises(ValueError, match="model's device"):
        ServeEngine(pb, meta)


def test_launch_serve_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--requests", "3",
                       "--prompt-len", "8", "--new-tokens", "3",
                       "--slots", "2"])
    out = capsys.readouterr().out
    assert "[launch.serve] 3 reqs x 3 new tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", STATE)
def test_launch_serve_state_archs_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "20", "--new-tokens", "3",
                       "--slots", "2"])
    out = capsys.readouterr().out
    assert "[launch.serve] 3 reqs x 3 new tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_moe_archs_on_the_cpu(arch, capsys):
    outs = launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--prompt-len", "12",
                              "--new-tokens", "3", "--slots", "2"])
    out = capsys.readouterr().out
    assert "[launch.serve] 3 reqs x 3 new tokens" in out and "on cpu" in out
    assert len(outs) == 3 and all(o.shape == (3,) for o in outs)


def test_launch_serve_refuses_what_waits(monkeypatch):
    """seamless fails where the reference's launcher does: its slot queue
    carries no source, and the encoder asks for one
    (``KeyError('src_embeds')``, in both packages); ``--ckpt-dir`` refuses
    a directory that holds no checkpoint."""
    from repro.launch import serve as jax_launch_serve

    argv = ["--arch", "seamless_m4t_medium", "--requests", "2",
            "--prompt-len", "8", "--new-tokens", "2"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(KeyError, match="src_embeds"):
        jax_launch_serve.main()
    with pytest.raises(KeyError, match="src_embeds"):
        launch_serve.main([*argv, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        launch_serve.main(["--device", "cpu", "--ckpt-dir", "nowhere"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--requests", "1"])
