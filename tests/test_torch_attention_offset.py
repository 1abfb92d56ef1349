"""The chunked-prefill offset (``q_offset``) through the port's attention
against the JAX package on the CPU.

``q_offset`` is the global index of query row 0: every mask reads query
row ``i`` as ``q_offset + i``, as the reference's ``_mask_for`` does. Inputs
are made with numpy from a seed and fed to both packages; the port takes
K4's and K4b's plain versions on CPU tensors (the kernels themselves are
held to those on the card by ``chip_smoke.py``). Tolerances: the forward
at 2e-5 in float32 (the reference's own), every gradient within 1e-3
relative L2 of ``jax.vjp`` (the port's gradient contract), chunks stacked
against the whole call at 1e-6 (the same plain arithmetic on the same
rows).

A query row with no live key (``window > 0`` and ``q_offset + Sq - Skv >=
window``) is refused by the port: the reference's answer there depends
on its kv block size, which the last test shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import _mask
from repro_torch.models import attention as port_attn

B, HQ, HKV, D = 2, 4, 2, 16      # GQA 2:1
# (sq, skv, q_offset): no offset, a chunk past the keys' middle, a chunk
# whose causal rows see only a prefix, and a last chunk of a prefill
SHAPES = [(8, 8, 0), (5, 13, 8), (7, 20, 3), (16, 40, 24)]
WINDOW = 6                       # inside every shape's keys: no dead row
FWD_BLOCK_KV = 7                 # divides none of the key lengths
GRAD_BLOCK_KV = 3                # nor does this


def _qkv(seed, sq, skv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, sq, HQ, D)).astype(np.float32),
            rng.normal(size=(B, skv, HKV, D)).astype(np.float32),
            rng.normal(size=(B, skv, HKV, D)).astype(np.float32))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


GRID = [(sq, skv, off, causal, window, cap)
        for sq, skv, off in SHAPES
        for causal in (True, False)
        for window in (0, WINDOW)
        for cap in (0.0, 30.0)]


@pytest.mark.parametrize("sq,skv,off,causal,window,cap", GRID)
def test_offset_forward_vs_jax(sq, skv, off, causal, window, cap):
    q, k, v = _qkv(sq * 100 + skv, sq, skv)
    got = port_attn.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        q_offset=off, attn_softcap=cap)
    want = jax_attn.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        q_offset=off, block_kv=FWD_BLOCK_KV, attn_softcap=cap)
    assert got.shape == (B, sq, HQ, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("sq,skv,off,causal,window,cap", GRID)
def test_offset_gradients_vs_jax_vjp(sq, skv, off, causal, window, cap):
    q, k, v = _qkv(sq * 100 + skv + 1, sq, skv)
    g = np.random.default_rng(sq + skv).normal(
        size=(B, sq, HQ, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, attn_softcap=cap)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    port_attn.flash_attention(*leaves, **kw).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda *a: jax_attn.flash_attention(*a, block_kv=GRAD_BLOCK_KV, **kw),
        *map(jnp.asarray, (q, k, v)))
    for name, leaf, want in zip("qkv", leaves, vjp(jnp.asarray(g))):
        rel = _rel_l2(leaf.grad.numpy(), want)
        assert rel < 1e-3, f"d{name}: relative L2 {rel:.2e}"


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("chunk", [4, 7, 12])
def test_chunks_stacked_equal_the_whole_call(chunk, window):
    """A prompt of 24 rows prefilled in chunks (each chunk's rows over
    every key up to its end, ``q_offset`` its first row) gives the whole
    call's rows, causal, on the plain version."""
    s = 24
    q, k, v = map(torch.from_numpy, _qkv(11, s, s))
    kw = dict(causal=True, window=window, softcap=30.0)
    whole = attn_ops.flash_attention(q, k, v, **kw)
    parts = [attn_ops.flash_attention(q[:, lo:lo + chunk],
                                      k[:, :lo + chunk], v[:, :lo + chunk],
                                      q_offset=lo, **kw)
             for lo in range(0, s, chunk)]
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(),
                               whole.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("off", [0, 7, 1000])
def test_local_attention_offset_vs_jax(off):
    q, k, v = _qkv(12, 24, 24)
    got = port_attn.local_attention(*map(torch.from_numpy, (q, k, v)),
                                    window=8, q_offset=off, attn_softcap=30.0)
    want = jax_attn.local_attention(*map(jnp.asarray, (q, k, v)), window=8,
                                    q_offset=off, block_q=16,
                                    attn_softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,off,window", [
    (6, 8, 5, 3), (6, 8, 4, 3), (1, 10, 12, 3), (4, 4, 0, 5), (3, 20, 9, 4),
])
def test_dead_row_condition_matches_the_reference_mask(sq, skv, off, window,
                                                       causal):
    """The refusal's static test is exactly "some row of the reference's
    ``_mask_for`` is all False", causal or not."""
    q_idx = off + jnp.arange(sq)
    k_idx = jnp.arange(skv)
    dead = not bool(np.asarray(
        jax_attn._mask_for(q_idx, k_idx, causal, window, skv)).any(-1).all())
    assert dead == (off + sq - skv >= window)
    q, k, v = map(torch.from_numpy, _qkv(13, sq, skv))
    if dead:
        with pytest.raises(ValueError, match="no live key"):
            port_attn.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off)
    else:
        port_attn.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=off)


def test_dead_row_raises_forward_and_backward():
    q, k, v = map(torch.from_numpy, _qkv(14, 6, 8))
    kw = dict(causal=True, window=3, q_offset=8)
    with pytest.raises(ValueError, match="no live key"):
        attn_ops.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="no live key"):
        attn_ops.flash_attention(*(t.requires_grad_(True) for t in (q, k, v)),
                                 **kw)
    qb, kb, vb = (t.detach().transpose(1, 2) for t in (q, k, v))
    lse = torch.zeros(qb.shape[:3])
    with pytest.raises(ValueError, match="no live key"):
        attn_ops.attention_bwd(qb, kb, vb, qb, qb, lse, causal=True,
                               window=3, q_offset=8)
    with pytest.raises(ValueError, match="q_offset"):
        attn_ops.flash_attention(q, k, v, q_offset=-1)


def test_reference_answers_a_dead_row_by_its_block_size():
    """Why the port refuses a dead row: the reference's output there is
    set by ``block_kv`` (its scan's padded keys read ``exp(0)``), so two
    block sizes give two answers for the same call, while its live rows
    agree."""
    q, k, v = map(jnp.asarray, _qkv(15, 6, 8))
    kw = dict(causal=True, window=3, q_offset=8)
    a = np.asarray(jax_attn.flash_attention(q, k, v, block_kv=3, **kw))
    b = np.asarray(jax_attn.flash_attention(q, k, v, block_kv=8, **kw))
    mask = _mask(6, 8, causal=True, window=3, q_offset=8, skv_valid=8,
                 device="cpu")
    dead = ~mask.any(dim=-1).numpy()
    assert dead.any() and not dead.all()
    np.testing.assert_allclose(a[:, ~dead], b[:, ~dead], atol=2e-6)
    assert np.abs(a[:, dead] - b[:, dead]).max() > 1e-3
