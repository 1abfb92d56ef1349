"""The port's chunked SSD (K5's dispatch and plain version) and the Mamba-2
block against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its default off a TPU), its
oracle ``repro.kernels.ssd.ssd_ref`` and the model's ``ssd_chunked``; the
port's ``kernels.ssd.ops`` take the plain version on a CPU tensor. The
mixer is held at the reference's own 1e-4 (``tests/test_kernels.py:56-68``),
layers at 1e-5 in float32. The CUDA kernels themselves are checked on the
card by ``chip_smoke.py``; here the bfloat16 route's arithmetic (float32
operands split into bf16 terms on the tensor cores) is rehearsed in plain
torch and held to the reference's 1e-4 and to the band ``chip_smoke.py``
holds the kernel to. Gradients (``ops.SSDChunked``: K5's forward, the
plain chunked version differentiated for the backward) are held against
``jax.grad`` of the reference's ``ssd_chunked`` and ``ssd_sequence`` at
1e-5 in relative L2 per leaf (the readings are about 1e-7).
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
    ssd_chunked, ssd_chunked_cuda, ssd_chunked_ref, ssd_chunked_split_ref,
    ssd_mixer, ssd_ref,
)
from repro_torch.kernels.ssd import kernel as k5_kernel
from repro_torch.kernels.ssd import ref as k5_ref
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


def test_cpu_tensors_launch_no_route():
    x, dt, a, bm, cm = (_t(v) for v in _mixer_inputs(4, 1, 2, 20, 8, 16))
    before = dict(ssd_chunked_cuda.route_launches)
    ssd_mixer(x.to(torch.bfloat16), dt, a, bm.to(torch.bfloat16),
              cm.to(torch.bfloat16), chunk=8)
    assert dict(ssd_chunked_cuda.route_launches) == before


def test_tensor_core_route_takes_16_byte_rows_in_place():
    """The bfloat16 route reads x (B, H, S, P) and B, C (B, S, N) where
    they lie, 16 bytes a copy: the model's strided views pass; a head dim
    or state dim that is no multiple of 8, or rows off a 16-byte boundary,
    are refused."""
    bf16 = torch.bfloat16
    proj = torch.zeros(2, 40, 4 * 64 + 2 * 128, dtype=bf16)  # (B, S, ...)
    x = proj[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    bm, cm = proj[..., 256:384], proj[..., 384:]
    k5_kernel.check_tensor_core_layout(x, bm, cm)
    with pytest.raises(ValueError, match="multiples of 8"):
        k5_kernel.check_tensor_core_layout(x[..., :60], bm, cm)
    with pytest.raises(ValueError, match="multiples of 8"):
        k5_kernel.check_tensor_core_layout(x, bm[..., :100], cm)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k5_kernel.check_tensor_core_layout(x, proj[..., 257:385], cm)


@pytest.mark.parametrize("b,h,s,p,n,q", CASES)
def test_plain_version_in_float64_holds_the_reference(b, h, s, p, n, q):
    """The plain version computed in float64 (the yardstick against which
    chip_smoke.py reads where a float32 result's error comes from), from
    an initial state: float64 out, within the reference's 1e-4 of the JAX
    model's ssd_chunked, and the float32 form within the same of it."""
    x, dt, a, bm, cm = _mixer_inputs(5, b, h, s, p, n)
    x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    h0 = np.random.default_rng(6).normal(size=(b, h, p, n)).astype(np.float32)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    y, h_last = ssd_chunked_ref(*args, q, _t(h0), dtype=torch.float64)
    assert y.dtype == h_last.dtype == torch.float64
    jy, jh = js.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), q,
                            jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(jy), **MIXER_TOL)
    np.testing.assert_allclose(_np(h_last), _np(jh), **MIXER_TOL)
    y32, h32 = ssd_chunked_ref(*args, q, _t(h0))
    np.testing.assert_allclose(_np(y32), _np(y), **MIXER_TOL)
    np.testing.assert_allclose(_np(h32), _np(h_last), **MIXER_TOL)


# ------------------------------------------------- the bf16 route's numerics

# K5's band on the card (chip_smoke.py K5_REL_L2) and its long-memory draws
# (K5_DT_LONG, K5_A_LONG)
K5_REL_L2 = 3e-5
K5_DT_LONG = (1e-3, 1e-2)
K5_A_LONG = (0.1, 0.5)


def _bf16_values(a):
    """``a`` rounded to bfloat16, as float32: the values that the route's
    bf16 operands hold, fed alike to both packages."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _split_inputs(seed, b, h, s, p, n, with_h0):
    """The model layout's inputs with x, B, C bf16-valued, and h0."""
    x, dt, a, bm, cm = _mixer_inputs(seed, b, h, s, p, n)
    x, bm, cm = (_bf16_values(v) for v in (x, bm, cm))
    x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    h0 = (np.random.default_rng(seed + 1).normal(size=(b, h, p, n))
          .astype(np.float32) if with_h0 else None)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,h,s,p,n,q", CASES + [(1, 3, 37, 8, 16, 16)])
def test_split_operands_hold_the_contract(b, h, s, p, n, q, with_h0):
    """K5's tensor-core arithmetic (bf16 C Bᵀ, dt on the float32 side, each
    float32 operand split into bf16 terms, float32 sums, the chunk states
    scanned apart) against the JAX model's ssd_chunked and, without h0,
    the Pallas kernel's oracle, at the reference's 1e-4; against the
    port's plain version within K5_REL_L2."""
    x, dt, a, bm, cm, h0 = _split_inputs(1, b, h, s, p, n, with_h0)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    h0_t = None if h0 is None else _t(h0)
    y, h_last = ssd_chunked_split_ref(*args, q, h0_t)
    jy, jh = js.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), q,
                            None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(jy), **MIXER_TOL)
    np.testing.assert_allclose(_np(h_last), _np(jh), **MIXER_TOL)
    if h0 is None:
        oracle = jax_ssd_ref(jnp.asarray(x.transpose(0, 2, 1, 3)),
                             jnp.asarray(dt.transpose(0, 2, 1)),
                             *(jnp.asarray(v) for v in (a, bm, cm)), q)
        np.testing.assert_allclose(_np(y).transpose(0, 2, 1, 3),
                                   _np(oracle), **MIXER_TOL)
    want = ssd_chunked_ref(*args, q, h0_t)
    assert _rel_l2(y, want[0]) < K5_REL_L2
    assert _rel_l2(h_last, want[1]) < K5_REL_L2


@pytest.mark.parametrize("with_h0", [False, True])
def test_split_operands_hold_the_band_over_a_long_memory(with_h0):
    """A reduced long-memory case (dt in U(1e-3, 1e-2), a in -U(0.1, 0.5):
    the state carried across chunks dominates y): the split arithmetic
    within K5_REL_L2 of the plain version, y and h_last; the unsplit
    control (one bf16 term an operand) outside, like the no-carry
    control."""
    b, h, s, p, n, q = 1, 4, 1000, 64, 128, 64
    rng = np.random.default_rng(11)
    x = _bf16_values(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = rng.uniform(*K5_DT_LONG, (b, s, h)).astype(np.float32)
    a = -rng.uniform(*K5_A_LONG, (h,)).astype(np.float32)
    bm, cm = (_bf16_values(rng.normal(size=(b, s, n)).astype(np.float32))
              for _ in range(2))
    h0 = (_t(rng.normal(size=(b, h, p, n)).astype(np.float32)) if with_h0
          else None)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    want = ssd_chunked_ref(*args, q, h0)
    split = ssd_chunked_split_ref(*args, q, h0)
    unsplit = ssd_chunked_split_ref(*args, q, h0, terms=(1, 1, 1))
    no_carry = [ssd_chunked_ref(*(v[:, t:t + q] for v in args[:2]), args[2],
                                *(v[:, t:t + q] for v in args[3:]), q)
                for t in range(0, s, q)]
    no_carry = (torch.cat([y for y, _ in no_carry], 1), no_carry[-1][1])
    for i in range(2):
        assert _rel_l2(split[i], want[i]) < K5_REL_L2
        assert _rel_l2(unsplit[i], want[i]) > K5_REL_L2
        assert _rel_l2(no_carry[i], want[i]) > K5_REL_L2


def _worst_share(got, want):
    """The largest |got - want| / (atol + rtol |want|) at MIXER_TOL: above
    1, an element falls outside the reference's 1e-4."""
    return float(((got - want).abs()
                  / (MIXER_TOL["atol"] + MIXER_TOL["rtol"] * want.abs()))
                 .max())


def test_h_prev_takes_a_third_term_over_a_serving_sequence():
    """One sequence of mamba2's prefill (4,600 tokens, 16 of its 64 heads)
    from a random initial state under a long memory, where C h_prevᵀ is
    the largest term of y: with every operand in three bf16 terms, as the
    kernel takes them, the worst element of y stays within half the
    reference's 1e-4; with h_prev in two it reaches past half (on the
    card, one element of the 64-head sequence fell outside 1e-4 so)."""
    b, h, s, p, n, q = 1, 16, 4600, 64, 128, 64
    rng = np.random.default_rng(11)
    x = _bf16_values(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = rng.uniform(*K5_DT_LONG, (b, s, h)).astype(np.float32)
    a = -rng.uniform(*K5_A_LONG, (h,)).astype(np.float32)
    bm, cm = (_bf16_values(rng.normal(size=(b, s, n)).astype(np.float32))
              for _ in range(2))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    want, _ = ssd_chunked_ref(*args, q, _t(h0))

    def worst(terms):
        return _worst_share(
            ssd_chunked_split_ref(*args, q, _t(h0), terms=terms)[0], want)

    assert worst(k5_ref.SPLIT_TERMS) < 0.5
    assert worst((3, 3, 2)) > 0.5


@pytest.mark.parametrize("two_terms", [(2, 3, 3), (3, 2, 3)],
                         ids=["S_L_dt", "x_w"])
def test_every_operand_takes_a_third_term_over_a_short_memory_sequence(
        two_terms):
    """One sequence of mamba2's prefill (16 heads) under the reference's
    short memory (dt in U(0.01, 0.2), a in -U(0.5, 2)), where y's own
    chunk dominates: with every operand in three bf16 terms the worst
    element of y takes under a tenth of the reference's 1e-4; with S ⊙ L ⊙
    dt_j or x ⊙ w in two, over a quarter, which over a serving batch's
    64 times as many elements leaves little margin."""
    b, h, s, p, n, q = 1, 16, 4600, 64, 128, 64
    rng = np.random.default_rng(12)
    x = _bf16_values(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm, cm = (_bf16_values(rng.normal(size=(b, s, n)).astype(np.float32))
              for _ in range(2))
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    want, _ = ssd_chunked_ref(*args, q)
    assert _worst_share(ssd_chunked_split_ref(*args, q)[0], want) < 0.1
    assert _worst_share(
        ssd_chunked_split_ref(*args, q, terms=two_terms)[0], want) > 0.25


@pytest.mark.parametrize("b,h,s,p,n,q", CASES)
def test_unsplit_operands_miss_the_band(b, h, s, p, n, q):
    """The control: float32 operands fed to the tensor cores as one bf16
    term read above K5_REL_L2 on the reference's cases, so the band tells
    the two designs apart."""
    x, dt, a, bm, cm, h0 = _split_inputs(1, b, h, s, p, n, True)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    want = ssd_chunked_ref(*args, q, _t(h0))
    unsplit = ssd_chunked_split_ref(*args, q, _t(h0), terms=(1, 1, 1))
    assert _rel_l2(unsplit[0], want[0]) > K5_REL_L2
    assert _rel_l2(unsplit[1], want[1]) > K5_REL_L2


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


# --------------------------------------------------------------------------- gradients

GRAD_REL_L2 = 1e-5


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_gradient_vs_jax(with_h0):
    """Every input's gradient through y and h_last, a ragged last chunk."""
    b, h, s, p, n, q = 2, 3, 37, 8, 16, 16
    x, dt, a, bm, cm = _mixer_inputs(15, b, h, s, p, n)
    x, dt = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    rng = np.random.default_rng(16)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gh = rng.normal(size=(b, h, p, n)).astype(np.float32)
    args = [x, dt, a, bm, cm] + ([h0] if with_h0 else [])

    def jloss(*xs):
        y, hl = js.ssd_chunked(*xs[:5], q, xs[5] if with_h0 else None)
        return jnp.sum(y * gy) + jnp.sum(hl * gh)

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(v) for v in args))
    leaves = [_t(v).requires_grad_() for v in args]
    y, hl = ssd_chunked(*leaves[:5], q, leaves[5] if with_h0 else None)
    before = k5_kernel.ssd_chunked_cuda.launches
    got = torch.autograd.grad((y * _t(gy)).sum() + (hl * _t(gh)).sum(),
                              leaves)
    assert k5_kernel.ssd_chunked_cuda.launches == before
    for name, gv, wv in zip(("x", "dt", "a_neg", "bmat", "cmat", "h0"),
                            got, want):
        assert _rel_l2(_np(gv), _np(wv)) < GRAD_REL_L2, name


def test_ssd_sequence_gradient_vs_jax(block):
    """``jax.grad`` of the reference's ``ssd_sequence`` (weighted sum of its
    output and final state) against the port's, for every parameter and
    the input."""
    jparams, params, cfg = block
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    gy = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    gh = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state)).astype(np.float32)

    def jloss(pp, xx):
        y, new = js.ssd_sequence(pp, xx, cfg)
        return jnp.sum(y * gy) + jnp.sum(new["h"] * gh)

    jg = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = _t(x).requires_grad_()
    y, new = ps.ssd_sequence(leaves, tx, cfg)
    loss = (y * _t(gy)).sum() + (new["h"] * _t(gh)).sum()
    got = dict(zip([*leaves, "x"],
                   torch.autograd.grad(loss, [*leaves.values(), tx])))
    want = dict(jg[0], x=jg[1])
    assert set(got) == set(want)
    for name in want:
        assert _rel_l2(_np(got[name]), _np(want[name])) < GRAD_REL_L2, name
