"""The port's chunked SSD (K5's dispatch and plain version) and the Mamba-2
block against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its default off a TPU), its
oracle ``repro.kernels.ssd.ssd_ref`` and the model's ``ssd_chunked``; the
port's ``kernels.ssd.ops`` take the plain version on a CPU tensor. The
mixer is held at the reference's own 1e-4 (``tests/test_kernels.py:56-68``),
layers at 1e-5 in float32. The CUDA kernel itself is checked on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssd import ssd_mixer as jax_ssd_mixer
from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.models import ssd as js
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import (
    ssd_chunked, ssd_chunked_cuda, ssd_chunked_ref, ssd_mixer, ssd_ref,
)
from repro_torch.models import ssd as ps

MIXER_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mixer_inputs(seed, b, h, s, p, n):
    """The reference test's draws, in its (B, H, S, P) layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, h, s)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


# the reference's three kernel cases (tests/test_kernels.py:56-68)
CASES = [(2, 4, 64, 16, 16, 16), (1, 2, 130, 32, 64, 32),
         (2, 8, 256, 64, 128, 64)]


@pytest.mark.parametrize("b,h,s,p,n,q", CASES)
def test_ssd_mixer_vs_jax_kernel_and_ref(b, h, s, p, n, q):
    args = _mixer_inputs(0, b, h, s, p, n)
    got = ssd_mixer(*(_t(a) for a in args), chunk=q)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, p)
    pallas = jax_ssd_mixer(*(jnp.asarray(a) for a in args), chunk=q)
    oracle = jax_ssd_ref(*(jnp.asarray(a) for a in args), q)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **MIXER_TOL)
    np.testing.assert_allclose(_np(ssd_ref(*(_t(a) for a in args), q)),
                               _np(oracle), **MIXER_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,h,s,p,n,q", CASES + [(1, 3, 37, 8, 16, 16)])
def test_ssd_chunked_y_and_h_last_vs_the_models_ssd_chunked(b, h, s, p, n, q,
                                                            with_h0):
    """The model's layout, the state out and (optionally) in, ragged S."""
    x, dt, a, bm, cm = _mixer_inputs(1, b, h, s, p, n)
    x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    h0 = (np.random.default_rng(2).normal(size=(b, h, p, n))
          .astype(np.float32) if with_h0 else None)
    y, h_last = ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), q,
                            None if h0 is None else _t(h0))
    jy, jh = js.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                            jnp.asarray(bm), jnp.asarray(cm), q,
                            None if h0 is None else jnp.asarray(h0))
    assert y.shape == (b, s, h, p) and h_last.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(y), _np(jy), **MIXER_TOL)
    np.testing.assert_allclose(_np(h_last), _np(jh), **MIXER_TOL)


def test_ssd_state_hand_off_and_chunk_size():
    """Two calls with the first's h_last handed to the second equal one
    call; the chunk size changes only the rounding."""
    x, dt, a, bm, cm = (_t(v) for v in _mixer_inputs(3, 2, 3, 50, 8, 16))
    x, dt = x.transpose(1, 2), dt.transpose(1, 2)
    y, h = ssd_chunked_ref(x, dt, a, bm, cm, 8)
    y1, h1 = ssd_chunked_ref(x[:, :21], dt[:, :21], a, bm[:, :21],
                             cm[:, :21], 8)
    y2, h2 = ssd_chunked_ref(x[:, 21:], dt[:, 21:], a, bm[:, 21:],
                             cm[:, 21:], 8, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **MIXER_TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **MIXER_TOL)
    y5, h5 = ssd_chunked_ref(x, dt, a, bm, cm, 5)
    np.testing.assert_allclose(y5.numpy(), y.numpy(), **MIXER_TOL)
    np.testing.assert_allclose(h5.numpy(), h.numpy(), **MIXER_TOL)


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    x, dt, a, bm, cm = (_t(v) for v in _mixer_inputs(4, 1, 2, 20, 8, 16))
    before = ssd_chunked_cuda.launches
    got = ssd_mixer(x, dt, a, bm, cm, chunk=8)
    assert ssd_chunked_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  ssd_ref(x, dt, a, bm, cm, 8).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunked_cuda(x, dt, a, bm, cm, chunk=8)
    assert ssd_chunked_cuda.launches == before


# --------------------------------------------------------------------------- the block


@pytest.fixture(scope="module")
def block():
    """(reference params, port params, cfg) of one reduced Mamba-2 block,
    the decay and step parameters drawn away from their init."""
    cfg = jax_config("mamba2_1_3b").reduce()
    params = dict(jax_init_params(js.ssd_specs(cfg), jax.random.key(5),
                                  jnp.float32))
    rng = np.random.default_rng(5)
    h = cfg.ssm_heads
    params["a_log"] = jnp.asarray(np.log(rng.uniform(1, 16, h)), jnp.float32)
    params["dt_bias"] = jnp.asarray(rng.uniform(-4, 1, h), jnp.float32)
    params["d_skip"] = jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32)
    params["norm_gamma"] = jnp.asarray(
        rng.normal(size=cfg.ssm_d_inner) * 0.1, jnp.float32)
    params["conv"] = jnp.asarray(
        rng.normal(size=params["conv"].shape) * 0.5, jnp.float32)
    port = {k: _t(v) for k, v in params.items()}
    return params, port, get_config("mamba2_1_3b").reduce()


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_sequence_vs_jax(block, with_state):
    jparams, params, cfg = block
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state)).astype(np.float32),
                 "conv": rng.normal(size=(2, cfg.conv_width - 1,
                                          cfg.ssm_d_inner + 2 * cfg.ssm_state))
                 .astype(np.float32)}
    y, new = ps.ssd_sequence(params, _t(x), cfg, None if state is None else
                             {k: _t(v) for k, v in state.items()})
    jy, jnew = js.ssd_sequence(jparams, jnp.asarray(x), cfg,
                               None if state is None else
                               {k: jnp.asarray(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(new[k]), _np(jnew[k]), **LAYER_TOL)


def test_ssd_step_vs_jax(block):
    jparams, params, cfg = block
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cache = {"h": rng.normal(size=(3, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)).astype(np.float32),
             "conv": rng.normal(size=(3, cfg.conv_width - 1,
                                      cfg.ssm_d_inner + 2 * cfg.ssm_state))
             .astype(np.float32)}
    y, new = ps.ssd_step(params, _t(x), {k: _t(v) for k, v in cache.items()},
                         cfg)
    jy, jnew = js.ssd_step(jparams, jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in cache.items()}, cfg)
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(new[k]), _np(jnew[k]), **LAYER_TOL)


def test_ssd_steps_after_a_prefill_continue_the_sequence(block):
    """The recurrent step, started from a sequence's state, gives the
    sequence's outputs: the chunked form and the step are one SSM."""
    _, params, cfg = block
    x = _t(np.random.default_rng(9).normal(size=(2, 22, cfg.d_model))
           .astype(np.float32))
    y, _ = ps.ssd_sequence(params, x, cfg)
    _, cache = ps.ssd_sequence(params, x[:, :13], cfg)
    for i in range(13, 22):
        out, cache = ps.ssd_step(params, x[:, i:i + 1], cache, cfg)
        np.testing.assert_allclose(out[:, 0].numpy(), y[:, i].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_ssd_cache_init_matches_the_reference():
    cfg = get_config("mamba2_1_3b").reduce()
    port = ps.ssd_cache_init(cfg, 3, torch.bfloat16, "cpu")
    ref = js.ssd_cache_init(jax_config("mamba2_1_3b").reduce(), 3,
                            jnp.bfloat16)
    assert sorted(port) == sorted(ref)
    for k in port:
        assert tuple(port[k].shape) == ref[k].shape
        assert port[k].dtype == torch.bfloat16 and not port[k].any()
