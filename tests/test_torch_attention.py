"""The port's flash-attention forward (K4's dispatch and plain version) and
the model's sequence attention against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas kernel in interpret mode (its default off a TPU) and
its pure-jnp oracle; the port's ``kernels.attention.ops.flash_attention``
takes its plain version on a CPU tensor. The tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32, 2e-2 in
bfloat16. The CUDA kernel itself is checked on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as jax_attention_ref
from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.models import attention as jax_attn
from repro_torch.kernels.attention import (
    attention_bhsd_ref, attention_ref, flash_attention, flash_attention_cuda,
)
from repro_torch.models import attention as port_attn

# the reference's five kernel cases (tests/test_kernels.py:25-29)
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 192, 192, 4, 4, 32, True, 0, 50.0),    # softcap (gemma2)
    (2, 256, 256, 8, 2, 64, True, 64, 0.0),    # sliding window
    (1, 64, 320, 2, 1, 128, False, 0, 0.0),    # cross-shape, MQA
    (1, 130, 130, 2, 2, 16, True, 0, 0.0),     # non-multiple of block
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
    _, (tq, tk, tv) = _both(_qkv(5, 1, 8, 8, 2, 2, 16), jnp.float32,
                            torch.float32)
    with pytest.raises(NotImplementedError, match="q_offset"):
        port_attn.flash_attention(tq, tk, tv, q_offset=3)
    with pytest.raises(NotImplementedError, match="q_offset"):
        port_attn.local_attention(tq, tk, tv, window=4, q_offset=3)


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
