"""The arithmetic of K4b's bfloat16 tensor-core route on the CPU.

``attention_bwd_rounded_ref`` states what that route computes: bf16
operands taken exactly, S and dP summed in float32, P and dS split into
``terms`` bf16 parts before the three gradient products. Here it is held
against the port's plain backward (``attention_bwd_ref``) and against
``jax.vjp`` of the reference's ``flash_attention`` (its hand-written VJP
``_flash_core_bwd``), on inputs made with numpy from a seed: the two-term
split the route takes must land within K4b's bfloat16 band
(``chip_smoke.py`` ``K4B_REL_L2["bfloat16"]``), the unsplit control
(bf16 P and dS, ``terms=1``) outside it. The kernel itself runs on the
card only (``chip_smoke.py`` holds it to the same band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels.attention import (
    attention_bhsd_ref, attention_bwd_ref, attention_bwd_rounded_ref,
    flash_attention, flash_attention_bwd_cuda, flash_attention_cuda,
)
from repro_torch.kernels.attention.ref import bf16_terms

# K4b's bfloat16 band on the card, relative L2 per gradient
K4B_REL_L2 = 2e-4
TERMS = 2   # the route's split of P and dS
# (b, s, hq, hkv, d, window, softcap, q scale): causal with the softcap
# (q x 8 puts the scores in its bend), and a windowed GQA shape with one
# key/value head
CASES = [
    (1, 128, 4, 2, 64, 0, 50.0, 1.0),
    (1, 128, 4, 2, 64, 0, 50.0, 8.0),
    (1, 256, 4, 1, 128, 64, 0.0, 1.0),
]


def _rel_l2(got, want) -> float:
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).norm() / want.norm())


def _inputs(case):
    """q, k, v and the output's cotangent in the model's (B, S, H, D)
    layout, float32 values that bfloat16 holds exactly."""
    b, s, hq, hkv, d, _, _, q_scale = case
    rng = np.random.default_rng(30)
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for h in (hq, hkv, hkv, hq)]
    arrays[0] *= q_scale
    return [torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()
            for a in arrays]


def _port(arrays, case, *, terms):
    """(rounded with ``terms``, plain) backward of the port on the bf16
    inputs, (B, H, S, D), from the plain forward's bf16 output and lse."""
    *_, window, cap, _ = case
    q, k, v, g = (torch.from_numpy(a).transpose(1, 2).to(torch.bfloat16)
                  for a in arrays)
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = attention_bhsd_ref(q, k, v, return_lse=True, **kw)
    return (attention_bwd_rounded_ref(q, k, v, out, g, lse, terms=terms,
                                      **kw),
            attention_bwd_ref(q, k, v, out, g, lse, **kw))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("terms", [TERMS, 1])
def test_rounded_backward_against_the_plain_version(case, terms):
    """The route's split holds the band against the plain backward on the
    same bf16 operands, per gradient; bf16 P and dS fall outside it."""
    rounded, plain = _port(_inputs(case), case, terms=terms)
    rels = [_rel_l2(x, y) for x, y in zip(rounded, plain)]
    assert all(x.dtype == torch.bfloat16 for x in rounded)
    if terms == TERMS:
        assert max(rels) < K4B_REL_L2, rels
    else:
        assert min(rels) > K4B_REL_L2, rels


@pytest.mark.parametrize("case", CASES[::2])
def test_rounded_backward_against_jax_vjp(case):
    """Against the reference's gradient (``jax.vjp`` in float32 on the
    same values, rounded once to bfloat16). The port's plain backward
    already stands off it by the bf16 rounding of the forward's output,
    which the kernel's contract reads (delta = rowsum(dO * O)); the route
    adds less than the band to that distance, the unsplit control more."""
    q, k, v, g = arrays = _inputs(case)
    *_, window, cap, _ = case
    _, vjp = jax.vjp(
        lambda q, k, v: jax_attn.flash_attention(
            q, k, v, causal=True, window=window, block_kv=64,
            attn_softcap=cap),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = [torch.from_numpy(np.array(x)).transpose(1, 2).to(torch.bfloat16)
            for x in vjp(jnp.asarray(g))]
    split, plain = _port(arrays, case, terms=TERMS)
    unsplit, _ = _port(arrays, case, terms=1)
    for name, s, u, p, w in zip("qkv", split, unsplit, plain, want):
        base = _rel_l2(p, w)
        assert _rel_l2(s, w) < base + K4B_REL_L2, name
        assert _rel_l2(u, w) > base + K4B_REL_L2, name


def test_bf16_terms_are_the_kernels_split():
    """Two terms are hi = bf16(x) and lo = bf16(x - hi), summed exactly in
    float32; one term is bf16(x); a value bf16 holds is its own split."""
    x = torch.from_numpy(np.random.default_rng(31).normal(
        size=4096).astype(np.float32))
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(bf16_terms(x, 1), hi)
    assert torch.equal(bf16_terms(x, 2), hi + lo)
    assert torch.equal(bf16_terms(hi, 2), hi)
    assert bool(((bf16_terms(x, 2) - x).abs() <= x.abs() * 2.0 ** -15).all())


def test_rounded_backward_takes_bf16_operands():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_bwd_rounded_ref(q, q[:, :1], q[:, :1], q, q,
                                  torch.zeros(1, 2, 8))


def test_cpu_gradients_launch_no_backward_kernel():
    """A bf16 gradient on CPU tensors takes the plain backward: no K4b
    launch, no route counted; the kernel refuses CPU tensors without
    counting."""
    arrays = _inputs(CASES[0])
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in arrays[:3])
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches,
              dict(flash_attention_bwd_cuda.route_launches))
    out = flash_attention(q, k, v, causal=True, softcap=50.0)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(arrays[3]).to(torch.bfloat16))
    assert all(x.dtype == torch.bfloat16 for x in grads)
    qb, kb, vb = (t.detach().transpose(1, 2) for t in (q, k, v))
    o, lse = attention_bhsd_ref(qb, kb, vb, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(qb, kb, vb, o, o, lse)
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches,
            dict(flash_attention_bwd_cuda.route_launches)) == before
