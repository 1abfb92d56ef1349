"""The port's flash-attention forward (K4's dispatch and plain version) and
the model's sequence attention against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its default off a TPU) and
its pure-jnp oracle; the port's ``kernels.attention.ops.flash_attention``
takes its plain version on a CPU tensor. The tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32, 2e-2 in
bfloat16. The CUDA kernels themselves are checked on the card by
``chip_smoke.py``; here the bfloat16 kernel's arithmetic (split
probabilities on the tensor cores) is emulated in plain torch and held to
the bands ``chip_smoke.py`` holds the kernel to.

The backward's plain version (``attention_bwd_ref``, K4b's counterpart on
the CPU, reached through ``ops.FlashAttention``) is held against
``jax.vjp`` of the reference's ``flash_attention`` (its hand-written VJP
``_flash_core_bwd``) and ``local_attention`` (autodiff of its q-block
scan) at 2e-5 in float32, the forward's own tolerance; the readings are
about 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as jax_attention_ref
from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.models import attention as jax_attn
from repro_torch.kernels.attention import (
    attention_bhsd_ref, attention_bwd_ref, attention_ref, flash_attention,
    flash_attention_bwd_cuda, flash_attention_cuda,
)
from repro_torch.kernels.attention import kernel as k4_kernel
from repro_torch.models import attention as port_attn

# the reference's five kernel cases (tests/test_kernels.py:25-29), then
# the encoder-decoder's cross attention at head dim 16: more queries than
# keys, and fewer over a key length that is no multiple of the block
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 192, 192, 4, 4, 32, True, 0, 50.0),    # softcap (gemma2)
    (2, 256, 256, 8, 2, 64, True, 64, 0.0),    # sliding window
    (1, 64, 320, 2, 1, 128, False, 0, 0.0),    # cross-shape, MQA
    (1, 130, 130, 2, 2, 16, True, 0, 0.0),     # non-multiple of block
    (2, 96, 40, 4, 2, 16, False, 0, 0.0),      # cross, Sq > Skv
    (1, 24, 75, 4, 2, 16, False, 0, 0.0),      # cross, Sq < Skv ragged
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


def _both(arrays, jdt, tdt):
    """The same values in both packages (the bf16 casts round alike)."""
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,cap", CASES)
def test_flash_attention_vs_jax_kernel_and_ref(b, sq, skv, hq, hkv, d, causal,
                                               window, cap, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, b, sq, skv, hq, hkv, d),
                                       jdt, tdt)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          softcap=cap)
    assert got.dtype == tdt and got.shape == (b, sq, hq, d)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 softcap=cap, block_q=64, block_kv=64)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal, window=window,
                               softcap=cap)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("q_offset", [0, 7])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_ref_vs_jax_ref(q_offset, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 9, 20, 4, 2, 16),
                                       jnp.float32, torch.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset, softcap=30.0)
    np.testing.assert_allclose(
        _np(attention_ref(tq, tk, tv, **kw)),
        _np(jax_attention_ref(jq, jk, jv, **kw)), atol=2e-5, rtol=2e-5)


def test_bhsd_ref_masks_keys_past_skv_valid():
    _, (tq, tk, tv) = _both(_qkv(2, 1, 12, 16, 2, 1, 16), jnp.float32,
                            torch.float32)
    q, k, v = (t.transpose(1, 2) for t in (tq, tk, tv))
    got = attention_bhsd_ref(q, k, v, causal=False, skv_valid=10)
    want = attention_bhsd_ref(q, k[:, :, :10], v[:, :, :10], causal=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("s,block", [(40, 128), (130, 64), (96, 32)])
def test_model_flash_attention_vs_jax(s, block):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 2, s, s, 4, 2, 32),
                                       jnp.float32, torch.float32)
    got = port_attn.flash_attention(tq, tk, tv, causal=True,
                                    attn_softcap=50.0)
    want = jax_attn.flash_attention(jq, jk, jv, causal=True, block_kv=block,
                                    attn_softcap=50.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,window", [(48, 16), (48, 32), (40, 64), (24, 24)])
def test_model_local_attention_vs_jax(s, window):
    """Window below the sequence (the local mask bites) and at or above it
    (only causality does)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 2, s, s, 4, 2, 16),
                                       jnp.float32, torch.float32)
    got = port_attn.local_attention(tq, tk, tv, window=window,
                                    attn_softcap=50.0)
    want = jax_attn.local_attention(jq, jk, jv, window=window, block_q=16,
                                    attn_softcap=50.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_model_attention_refuses_a_query_offset():
    """A query offset that leaves a query row no live key (the window's
    end before the keys', ``q_offset + Sq - Skv >= window``) is refused
    with ``ValueError``; one that leaves every row a live key computes
    what the reference computes, and the local path computes at any
    offset."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, 8, 8, 2, 2, 16),
                                       jnp.float32, torch.float32)
    got = port_attn.flash_attention(tq, tk, tv, q_offset=3, window=4)
    want = jax_attn.flash_attention(jq, jk, jv, q_offset=3, window=4)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="q_offset"):
        port_attn.flash_attention(tq, tk, tv, q_offset=4, window=4)
    np.testing.assert_allclose(
        _np(port_attn.local_attention(tq, tk, tv, window=4, q_offset=3)),
        _np(jax_attn.local_attention(jq, jk, jv, window=4, q_offset=3)),
        atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    _, (tq, tk, tv) = _both(_qkv(6, 1, 16, 16, 2, 1, 16), jnp.float32,
                            torch.float32)
    before = flash_attention_cuda.launches
    got = flash_attention(tq, tk, tv, causal=True)
    assert flash_attention_cuda.launches == before
    np.testing.assert_allclose(_np(got), _np(attention_ref(tq, tk, tv)),
                               atol=2e-6, rtol=2e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(*(t.transpose(1, 2).contiguous()
                               for t in (tq, tk, tv)))
    assert flash_attention_cuda.launches == before


def test_cpu_tensors_launch_no_route():
    _, (tq, tk, tv) = _both(_qkv(7, 1, 16, 16, 2, 1, 16), jnp.bfloat16,
                            torch.bfloat16)
    before = dict(flash_attention_cuda.route_launches)
    flash_attention(tq, tk, tv, causal=True)
    assert dict(flash_attention_cuda.route_launches) == before


def test_kernel_strides_read_the_model_layout_in_place():
    """The kernels take (B, H, S, D) by index through element strides: a
    transposed view of the model's (B, S, H, D) tensor passes as it lies;
    a last dimension that is not contiguous, or rows off a 16-byte
    boundary, are refused."""
    x = torch.zeros(2, 40, 4, 32, dtype=torch.bfloat16)   # (B, S, H, D)
    assert k4_kernel.strides(x.transpose(1, 2)) == (40 * 4 * 32, 32, 4 * 32)
    assert k4_kernel.strides(x.transpose(1, 2).contiguous()) == (
        4 * 40 * 32, 40 * 32, 32)
    with pytest.raises(ValueError, match="last dimension is contiguous"):
        k4_kernel.strides(x.transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte boundary"):
        k4_kernel.strides(x[..., 1:17])
    y = torch.zeros(2, 40, 4, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-byte boundary"):
        k4_kernel.strides(y.transpose(1, 2))   # 72-byte rows


# -------------------------------------------------- the bf16 kernel's numerics

# K4's bands on the card (chip_smoke.py K4_TOL["bfloat16"], K4_REL_L2)
K4_BF16_TOL = (1e-5, 2.0 ** -7)
K4_REL_L2 = 3e-4
# the reference's five cases and q x 8, whose scores reach the softcap's
# bend, at gemma2's head dim
SPLIT_CASES = [(*c, 1.0) for c in CASES] + [
    (1, 256, 256, 4, 2, 256, True, 128, 50.0, 8.0)]


def _emulate_tensor_core_kernel(q, k, v, *, causal, window, softcap,
                                split=True, step=32):
    """The bfloat16 tensor-core kernel's arithmetic in plain torch, (B, H,
    S, D): S from the unscaled bf16 q and k in float32, then scaled by
    1/sqrt(d); the softcap as c tanh(s (1/c)); the masks; the online softmax
    over ``step`` keys at a time; P split into bf16 hi = bf16(p) and lo =
    bf16(p - hi), each multiplied by V in float32 and both added
    (``split=False``: hi alone, a kernel that feeds bf16 P to the tensor
    cores)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    m = torch.full((b, hkv, hq // hkv, sq), -2e38)
    l = torch.zeros(b, hkv, hq // hkv, sq)
    acc = torch.zeros(b, hkv, hq // hkv, sq, d)
    qi = torch.arange(sq)[:, None]
    for lo in range(0, skv, step):
        kb, vb = kf[:, :, lo:lo + step], vf[:, :, lo:lo + step]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s * torch.tensor(1.0 / softcap))
        ki = lo + torch.arange(kb.shape[2])[None, :]
        mask = torch.ones(sq, kb.shape[2], dtype=torch.bool)
        if causal:
            mask &= qi >= ki
        if window > 0:
            mask &= qi - ki < window
        s = torch.where(mask, s, torch.tensor(-2e38))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhgqk,bhkd->bhgqd", hi, vb)
        if split:
            lo_ = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhgqk,bhkd->bhgqd", lo_, vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _split_case(case):
    b, sq, skv, hq, hkv, d, causal, window, cap, q_scale = case
    q, k, v = _qkv(0, b, sq, skv, hq, hkv, d)
    (jq, jk, jv), (tq, tk, tv) = _both((q * q_scale, k, v), jnp.bfloat16,
                                       torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=cap)
    bhsd = [t.transpose(1, 2) for t in (tq, tk, tv)]
    want = attention_bhsd_ref(*bhsd, **kw)
    pallas = torch.from_numpy(_np(jax_flash_attention(
        jq, jk, jv, block_q=64, block_kv=64, **kw))).transpose(1, 2)
    return bhsd, kw, want, pallas


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_probabilities_hold_k4_bands(case):
    """Split P holds K4's bfloat16 bands against the plain version and the
    Pallas kernel: one unit in the last place elementwise, relative L2
    below 3e-4."""
    bhsd, kw, want, pallas = _split_case(case)
    got = _emulate_tensor_core_kernel(*bhsd, **kw)
    assert got.dtype == torch.bfloat16
    atol, rtol = K4_BF16_TOL
    for ref in (want, pallas):
        np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol)
        assert _rel_l2(got, ref) < K4_REL_L2


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_bf16_probabilities_miss_the_band(case):
    """The control: bf16 P alone reads above K4_REL_L2 on the same inputs,
    so the band tells the two designs apart."""
    bhsd, kw, want, _ = _split_case(case)
    control = _emulate_tensor_core_kernel(*bhsd, **kw, split=False)
    assert _rel_l2(control, want) > K4_REL_L2


# --------------------------------------------------------------------------- backward

GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _vjp_both(jfn, tfn, arrays, g):
    """(port grads, reference grads) of q, k, v for the cotangent g."""
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.autograd.grad(tfn(*leaves), leaves, torch.from_numpy(g))
    return got, want


# (b, s, hq, hkv, d, window, softcap): GQA, MQA, a window, the softcap, S
# ragged against the reference's kv block
BWD_CASES = [
    (2, 40, 4, 2, 16, 0, 50.0),
    (1, 37, 4, 1, 32, 0, 0.0),
    (2, 48, 4, 2, 16, 16, 50.0),
    (1, 70, 2, 2, 64, 0, 30.0),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,cap", BWD_CASES)
def test_flash_attention_gradient_vs_jax_vjp(b, s, hq, hkv, d, window, cap):
    q, k, v = _qkv(20, b, s, s, hq, hkv, d)
    g = np.random.default_rng(21).normal(size=q.shape).astype(np.float32)
    got, want = _vjp_both(
        lambda q, k, v: jax_attn.flash_attention(
            q, k, v, causal=True, window=window, block_kv=16,
            attn_softcap=cap),
        lambda q, k, v: port_attn.flash_attention(
            q, k, v, causal=True, attn_softcap=cap) if window == 0 else
        port_attn.local_attention(q, k, v, window=window, attn_softcap=cap),
        (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [c[:6] for c in CASES
                                               if not c[6]])
def test_non_causal_gradient_vs_jax_vjp(b, sq, skv, hq, hkv, d):
    """The encoder's and the cross attention's backward (no mask, ``Sq``
    against ``Skv``, both ragged against the reference's kv block)."""
    q, k, v = _qkv(24, b, sq, skv, hq, hkv, d)
    g = np.random.default_rng(25).normal(size=q.shape).astype(np.float32)
    got, want = _vjp_both(
        lambda q, k, v: jax_attn.flash_attention(q, k, v, causal=False,
                                                 block_kv=16),
        lambda q, k, v: port_attn.flash_attention(q, k, v, causal=False),
        (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("s,window", [(48, 16), (40, 64)])
def test_local_attention_gradient_vs_jax_vjp(s, window):
    """Autodiff of the reference's q-block scan, window below and above
    the sequence."""
    q, k, v = _qkv(22, 2, s, s, 4, 2, 16)
    g = np.random.default_rng(23).normal(size=q.shape).astype(np.float32)
    got, want = _vjp_both(
        lambda q, k, v: jax_attn.local_attention(
            q, k, v, window=window, block_q=16, attn_softcap=50.0),
        lambda q, k, v: port_attn.local_attention(
            q, k, v, window=window, attn_softcap=50.0),
        (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL, err_msg=name)


def test_forward_lse_is_the_row_log_sum_exp():
    """``return_lse`` gives ``m + log(l)`` of the masked, capped scores, in
    float32, for the backward to recompute P from."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(24, 2, 30, 30, 4, 2, 16))
    out, lse = attention_bhsd_ref(q, k, v, causal=True, window=7,
                                  softcap=20.0, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 30)
    torch.testing.assert_close(out, attention_bhsd_ref(
        q, k, v, causal=True, window=7, softcap=20.0), rtol=0, atol=0)
    kk = k.repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q / 4.0, kk)
    s = 20.0 * torch.tanh(s / 20.0)
    i = torch.arange(30)
    mask = (i[:, None] >= i[None]) & (i[:, None] - i[None] < 7)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=2e-6, rtol=2e-6)


def test_gradients_on_cpu_tensors_take_the_plain_backward():
    """With a gradient wanted, the model's attention goes through the
    autograd Function; on CPU tensors it launches no kernel, and its
    backward equals ``attention_bwd_ref`` on the saved tensors."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(25, 1, 20, 20, 4, 2, 16))
    g = torch.from_numpy(np.random.default_rng(26).normal(
        size=(1, 20, 4, 16)).astype(np.float32))
    before = (flash_attention_cuda.launches, flash_attention_bwd_cuda.launches)
    out = flash_attention(q, k, v, causal=True, softcap=30.0)
    # the model-layout output is a view of the Function's
    assert "FlashAttention" in out.grad_fn.next_functions[0][0].name()
    got = torch.autograd.grad(out, (q, k, v), g)
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == before
    qb, kb, vb = (t.detach().transpose(1, 2) for t in (q, k, v))
    o, lse = attention_bhsd_ref(qb, kb, vb, causal=True, softcap=30.0,
                                return_lse=True)
    want = attention_bwd_ref(qb, kb, vb, o, g.transpose(1, 2), lse,
                             causal=True, softcap=30.0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w.transpose(1, 2), rtol=0, atol=0)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(qb, kb, vb, o, g.transpose(1, 2), lse)
