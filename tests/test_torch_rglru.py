"""The port's RG-LRU scan (K6's dispatch and plain version) and the RG-LRU
block against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its default off a TPU) and
its associative-scan oracle; the port's ``kernels.rglru.ops.rglru_scan``
takes its sequential plain version on a CPU tensor. Scans are held at the
reference's own 1e-4 (``tests/test_kernels.py:44-53``), layers at 1e-5 in
float32. The CUDA kernel itself is checked on the card by
``chip_smoke.py``; here its wrapper refuses CPU tensors without counting a
launch. Gradients (``ops.RGLRUScan``: the same scan run backwards over the
reversed inputs) are held against ``jax.vjp`` of the reference's
associative scan and ``jax.grad`` of its ``rglru_sequence`` at 1e-5 in
relative L2 per leaf: the associative scan rounds in another order (the
readings here are about 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rglru import rglru_scan_ref as jax_rglru_scan_ref
from repro.models import rglru as jr
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.kernels.rglru import (
    rglru_scan, rglru_scan_cuda, rglru_scan_ref,
)
from repro_torch.kernels.rglru import ops as k6_ops
from repro_torch.models import rglru as pr

SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scan_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 0.999, (b, s, w)).astype(np.float32),
            rng.normal(size=(b, s, w)).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32))


# the reference's four kernel cases (tests/test_kernels.py:44-53)
@pytest.mark.parametrize("b,s,w,bt", [(2, 64, 32, 16), (1, 300, 100, 128),
                                      (3, 512, 256, 256), (1, 16, 8, 16)])
def test_rglru_scan_vs_jax_kernel_and_ref(b, s, w, bt):
    a, x, h0 = _scan_inputs(0, b, s, w)
    got = rglru_scan(_t(a), _t(x), _t(h0))
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    pallas = jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                            block_t=bt)
    oracle = jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                jnp.asarray(h0))
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def test_rglru_scan_without_h0_starts_from_zeros():
    a, x, _ = _scan_inputs(1, 2, 40, 24)
    got = rglru_scan(_t(a), _t(x))
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
    np.testing.assert_array_equal(
        _np(got), _np(rglru_scan(_t(a), _t(x), torch.zeros(2, 24))))


def test_rglru_scan_returns_the_input_dtype():
    """As the reference wrapper: float32 inside, ``a``'s dtype out."""
    a, x, h0 = _scan_inputs(2, 1, 20, 16)
    ab, xb = (torch.from_numpy(v).to(torch.bfloat16) for v in (a, x))
    got = rglru_scan(ab, xb, _t(h0))
    want = jax_rglru_scan(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(h0))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_rglru_scan_is_the_sequential_recurrence():
    """The plain version is the kernel's loop: each step the rounded
    product, then the rounded sum, bit for bit."""
    a, x, h0 = _scan_inputs(3, 2, 30, 8)
    h = h0.copy()
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        want[:, t] = h
    np.testing.assert_array_equal(rglru_scan_ref(_t(a), _t(x), _t(h0)).numpy(),
                                  want)


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    a, x, h0 = (_t(v) for v in _scan_inputs(4, 1, 12, 8))
    before = rglru_scan_cuda.launches
    got = rglru_scan(a, x, h0)
    assert rglru_scan_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  rglru_scan_ref(a, x, h0).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan_cuda(a, x, h0)
    assert rglru_scan_cuda.launches == before


def test_cpu_scan_leaves_both_launch_counters_alone():
    """Neither the forward nor the backward scan counts a launch on the
    CPU (the backward's launches count on the same counter)."""
    a, x, h0 = (_t(v) for v in _scan_inputs(5, 2, 40, 24))
    before = rglru_scan_cuda.launches
    rglru_scan(a, x, h0)
    rglru_scan(a, x)
    a.requires_grad_()
    rglru_scan(a, x, h0).sum().backward()
    assert a.grad is not None
    assert rglru_scan_cuda.launches == before


GRAD_REL_L2 = 1e-5


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("b,s,w,with_h0", [(1, 300, 100, True),
                                           (2, 77, 40, False)])
def test_rglru_scan_gradient_vs_jax(b, s, w, with_h0):
    a, x, h0 = _scan_inputs(10, b, s, w)
    g = np.random.default_rng(11).normal(size=(b, s, w)).astype(np.float32)
    if not with_h0:
        h0 = np.zeros_like(h0)     # the reference's zeros; the port's None
    _, vjp = jax.vjp(jax_rglru_scan_ref, *(jnp.asarray(v) for v in (a, x, h0)))
    want = vjp(jnp.asarray(g))
    leaves = [_t(v).requires_grad_() for v in ((a, x, h0) if with_h0
                                               else (a, x))]
    got = torch.autograd.grad(rglru_scan(*leaves), leaves, _t(g))
    for name, gv, wv in zip(("da", "db", "dh0"), got, want):
        assert _rel_l2(_np(gv), _np(wv)) < GRAD_REL_L2, name


def test_rglru_scan_backward_is_the_reversed_scan():
    """``dh_t = g_t + a_{t+1} dh_{t+1}`` written out: ``db = dh``, ``da_t
    = dh_t h_{t-1}``, ``dh0 = a_0 dh_0``, exactly as the backward computes
    them with the sequential plain scan."""
    a, x, h0 = (_t(v) for v in _scan_inputs(12, 2, 30, 8))
    g = _t(np.random.default_rng(13).normal(size=(2, 30, 8))
           .astype(np.float32))
    h = rglru_scan_ref(a, x, h0)
    dh = torch.empty_like(g)
    carry = torch.zeros_like(g[:, 0])
    for t in range(29, -1, -1):
        nxt = a[:, t + 1] if t + 1 < 30 else torch.zeros_like(carry)
        carry = nxt * carry + g[:, t]
        dh[:, t] = carry
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    da, db, dh0 = k6_ops.rglru_scan_bwd(a, h, h0, g)
    torch.testing.assert_close(db, dh, rtol=0, atol=0)
    torch.testing.assert_close(da, dh * h_prev, rtol=0, atol=0)
    torch.testing.assert_close(dh0, a[:, 0] * dh[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_sequence_gradient_vs_jax(block, with_state):
    """``jax.grad`` of the reference's ``rglru_sequence`` (weighted sum of
    its output and final state) against the port's, for every parameter,
    the input and the initial state."""
    jparams, params, cfg = block
    rng = np.random.default_rng(14)
    w = cfg.resolved_lru_width
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, w)).astype(np.float32) if with_state else None
    gy = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    gh = rng.normal(size=(2, w)).astype(np.float32)

    def jloss(p, xx, hh):
        y, (hl, _) = jr.rglru_sequence(p, xx, cfg, hh)
        return jnp.sum(y * gy) + jnp.sum(hl * gh)

    jh0 = None if h0 is None else jnp.asarray(h0)
    jg = jax.grad(jloss, argnums=(0, 1, 2) if with_state else (0, 1))(
        jparams, jnp.asarray(x), jh0)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx = _t(x).requires_grad_()
    th0 = None if h0 is None else _t(h0).requires_grad_()
    y, (hl, _) = pr.rglru_sequence(leaves, tx, cfg, th0)
    loss = (y * _t(gy)).sum() + (hl * _t(gh)).sum()
    wrt = [*leaves.values(), tx] + ([th0] if with_state else [])
    got = dict(zip([*leaves, "x", "h0"], torch.autograd.grad(loss, wrt)))
    want = dict(jg[0], x=jg[1], **({"h0": jg[2]} if with_state else {}))
    assert set(got) == set(want)
    for name in want:
        assert _rel_l2(_np(got[name]), _np(want[name])) < GRAD_REL_L2, name


# --------------------------------------------------------------------------- the block


@pytest.fixture(scope="module")
def block():
    """(reference params, port params, cfg) of one reduced RG-LRU block,
    the gates and decay drawn away from their init so every term moves."""
    cfg = jax_config("recurrentgemma_2b").reduce()
    params = jax_init_params(jr.rglru_specs(cfg), jax.random.key(5),
                             jnp.float32)
    rng = np.random.default_rng(5)
    w = cfg.resolved_lru_width
    params = dict(params)
    for name, lo, hi in (("a_diag", 0.5, 1.5), ("a_bias", -1, 1),
                         ("i_diag", 0.5, 1.5), ("i_bias", -1, 1),
                         ("lam", 1.0, 6.0)):
        params[name] = jnp.asarray(rng.uniform(lo, hi, w), jnp.float32)
    params["conv"] = jnp.asarray(rng.normal(size=(cfg.conv_width, w)) * 0.5,
                                 jnp.float32)
    port = {k: _t(v) for k, v in params.items()}
    return params, port, get_config("recurrentgemma_2b").reduce()


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_vs_jax(with_tail):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_tail \
        else None
    y, new_tail = pr.causal_conv1d(_t(x), _t(w),
                                   None if tail is None else _t(tail))
    jy, jtail = jr.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if tail is None else jnp.asarray(tail))
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    np.testing.assert_array_equal(_np(new_tail), _np(jtail))


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_sequence_vs_jax(block, with_state):
    jparams, params, cfg = block
    rng = np.random.default_rng(7)
    w = cfg.resolved_lru_width
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, w)).astype(np.float32) if with_state else None
    tail = rng.normal(size=(2, cfg.conv_width - 1, w)).astype(np.float32) \
        if with_state else None
    y, (hl, new_tail) = pr.rglru_sequence(
        params, _t(x), cfg, None if h0 is None else _t(h0),
        None if tail is None else _t(tail))
    jy, (jhl, jtail) = jr.rglru_sequence(
        jparams, jnp.asarray(x), cfg, None if h0 is None else jnp.asarray(h0),
        None if tail is None else jnp.asarray(tail))
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    np.testing.assert_allclose(_np(hl), _np(jhl), **LAYER_TOL)
    np.testing.assert_array_equal(_np(new_tail), _np(jtail))


def test_rglru_step_vs_jax(block):
    jparams, params, cfg = block
    rng = np.random.default_rng(8)
    w = cfg.resolved_lru_width
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cache = {"h": rng.normal(size=(3, w)).astype(np.float32),
             "conv": rng.normal(size=(3, cfg.conv_width - 1, w))
             .astype(np.float32)}
    y, new = pr.rglru_step(params, _t(x), {k: _t(v) for k, v in cache.items()},
                           cfg)
    jy, jnew = jr.rglru_step(jparams, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             cfg)
    np.testing.assert_allclose(_np(y), _np(jy), **LAYER_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(new[k]), _np(jnew[k]), **LAYER_TOL)


def test_rglru_state_hand_off_continues_the_sequence(block):
    """A sequence run in two parts, the first's (h, conv tail) handed to the
    second, gives the one-part outputs and final state; steps after a
    prefill give the sequence's outputs."""
    _, params, cfg = block
    x = _t(np.random.default_rng(9).normal(size=(2, 20, cfg.d_model))
           .astype(np.float32))
    y, (hl, tail) = pr.rglru_sequence(params, x, cfg)
    y1, (h1, t1) = pr.rglru_sequence(params, x[:, :11], cfg)
    y2, (h2, t2) = pr.rglru_sequence(params, x[:, 11:], cfg, h1, t1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **LAYER_TOL)
    np.testing.assert_allclose(h2.numpy(), hl.numpy(), **LAYER_TOL)
    np.testing.assert_array_equal(t2.numpy(), tail.numpy())
    cache = {"h": h1, "conv": t1}
    for i in range(11, 20):
        out, cache = pr.rglru_step(params, x[:, i:i + 1], cache, cfg)
        np.testing.assert_allclose(out[:, 0].numpy(), y[:, i].numpy(),
                                   **LAYER_TOL)


def test_rglru_cache_init_matches_the_reference():
    cfg = get_config("recurrentgemma_2b").reduce()
    port = pr.rglru_cache_init(cfg, 3, torch.bfloat16, "cpu")
    ref = jr.rglru_cache_init(jax_config("recurrentgemma_2b").reduce(), 3,
                              jnp.bfloat16)
    assert sorted(port) == sorted(ref)
    for k in port:
        assert tuple(port[k].shape) == ref[k].shape
        assert port[k].dtype == torch.bfloat16 and not port[k].any()
