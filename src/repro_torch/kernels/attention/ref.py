"""Plain PyTorch version of the flash-attention forward (K4).

It runs on any device. The CPU tests hold it against the JAX package's
``repro/kernels/attention/ref.py`` and Pallas kernel, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.

It materialises the full ``(Sq, Skv)`` score matrix in float32, O(S^2)
memory, so it is unambiguous rather than fast. Two forms of the forward:

- :func:`attention_ref` in the model's ``(B, S, H, D)`` layout, the
  counterpart of ``repro/kernels/attention/ref.py`` ``attention_ref``
  (``q_offset`` shifts the query indices, as for a chunked prefill);
- :func:`attention_bhsd_ref` in the ``(B, H, S, D)`` layout that the CUDA
  wrapper's contract is stated in, with the reference kernel's
  ``skv_valid`` (keys at or past it are masked).

Scores are ``q·k / sqrt(d)`` with q cast to float32 and scaled first, the
optional softcap ``c·tanh(s/c)`` is applied before the masks, masked
scores are ``-2e38``, the softmax is float32 and the output takes the
input's dtype. GQA: query head ``h`` reads key/value head ``h // (Hq/Hkv)``.
With ``return_lse`` the forward also gives each row's log-sum-exp
``m + log(max(l, 1e-37))`` in float32, as the reference's
``_flash_fwd_scan`` does (``repro/models/attention.py:138-150``).

:func:`attention_bwd_ref` is the backward (K4b's plain version), a port of
the reference's hand-written VJP ``_flash_core_bwd``
(``repro/models/attention.py:181-215``) without its kv blocks: ``P`` is
recomputed from the forward's ``lse``, ``delta = rowsum(dO * O)``, ``dS =
P (dP - delta)``, times ``1 - tanh(u / c)^2`` on the pre-cap scores ``u``
where there is a softcap, masked to 0; the query gradient is taken through
the ``1/sqrt(d)`` scale, and the key and value gradients of a GQA group sum
over its query heads, as autodiff of ``_expand_kv`` does.

:func:`attention_bwd_rounded_ref` states the arithmetic of K4b's bfloat16
tensor-core route in plain torch, for the tests and ``chip_smoke.py``:
bf16 operands taken exactly, S and dP summed in float32 and scaled there,
and P and dS split into ``terms`` bf16 parts before the three gradient
products (``terms=1``: bf16 P and dS, the unsplit control).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def softcap_fn(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def softcap_grad(u: torch.Tensor, cap: float) -> torch.Tensor:
    """The softcap's derivative at the pre-cap scores ``u``."""
    return 1.0 - torch.square(torch.tanh(u / cap))


def _mask(sq: int, skv: int, *, causal: bool, window: int, q_offset: int,
          skv_valid: int, device) -> torch.Tensor:
    q_idx = q_offset + torch.arange(sq, device=device)[:, None]
    k_idx = torch.arange(skv, device=device)[None, :]
    mask = k_idx < skv_valid
    if causal:
        mask = mask & (q_idx >= k_idx)
    if window > 0:
        mask = mask & (q_idx - k_idx < window)
    return mask


def attention_bhsd_ref(
    q: torch.Tensor,              # (B, Hq, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,              # 0 => unbounded
    softcap: float = 0.0,
    q_offset: int = 0,
    skv_valid: int | None = None,
    return_lse: bool = False,
):
    """``out`` in q's dtype, or ``(out, lse)`` with ``return_lse``, lse
    ``(B, Hq, Sq)`` float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, sq, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32))
    if softcap > 0:
        s = softcap_fn(s, softcap)
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 skv_valid=skv if skv_valid is None else skv_valid,
                 device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return out, lse.reshape(b, hq, sq)


def attention_bwd_ref(
    q: torch.Tensor,              # (B, Hq, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Skv, D)
    v: torch.Tensor,
    out: torch.Tensor,            # (B, Hq, Sq, D), the forward's output
    dout: torch.Tensor,           # (B, Hq, Sq, D), its cotangent
    lse: torch.Tensor,            # (B, Hq, Sq) float32, the forward's
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the dtypes of q, k and v, computed in float32
    (query row ``i`` masked as the global row ``q_offset + i``)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    qf = q.to(f32).reshape(b, hkv, g, sq, d) * scale
    kf, vf = k.to(f32), v.to(f32)
    gf = dout.to(f32).reshape(b, hkv, g, sq, d)
    lse5 = lse.to(f32).reshape(b, hkv, g, sq)
    delta = (gf * out.to(f32).reshape(b, hkv, g, sq, d)).sum(dim=-1)
    u = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)        # pre-cap scores
    s = softcap_fn(u, softcap) if softcap > 0 else u
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 skv_valid=skv, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse5[..., None])
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, gf)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gf, vf)
    ds = p * (dp - delta[..., None])
    if softcap > 0:
        ds = ds * softcap_grad(u, softcap)
    ds = torch.where(mask, ds, torch.zeros((), device=q.device))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bf16_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """``x`` (float32) as the float32 sum of ``terms`` bf16 parts, each the
    bf16 rounding of what the earlier parts leave: what the tensor cores
    see of a float32 operand split that many ways."""
    total = torch.zeros_like(x)
    for _ in range(terms):
        total = total + (x - total).to(torch.bfloat16).to(x.dtype)
    return total


def attention_bwd_rounded_ref(
    q: torch.Tensor,              # (B, Hq, Sq, D) bfloat16
    k: torch.Tensor,              # (B, Hkv, Skv, D) bfloat16
    v: torch.Tensor,
    out: torch.Tensor,            # (B, Hq, Sq, D) bfloat16, the forward's
    dout: torch.Tensor,           # (B, Hq, Sq, D) bfloat16
    lse: torch.Tensor,            # (B, Hq, Sq) float32, the forward's
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    terms: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attention_bwd_ref` as K4b's tensor-core route rounds it:
    ``u = (q k) / sqrt(d)`` and ``dP = dO v`` from the bf16 values in
    float32, scaled after the sum; P and dS in float32 as the reference
    has them, then each taken as ``terms`` bf16 parts (:func:`bf16_terms`)
    for ``dV = Pᵀ dO``, ``dK = dSᵀ q / sqrt(d)`` and ``dQ = dS k /
    sqrt(d)``, summed in float32 and rounded once to bfloat16."""
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v, out, dout)):
        raise TypeError("the rounded backward takes bfloat16 operands")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    qf = q.to(f32).reshape(b, hkv, g, sq, d)
    kf, vf = k.to(f32), v.to(f32)
    gf = dout.to(f32).reshape(b, hkv, g, sq, d)
    lse5 = lse.reshape(b, hkv, g, sq)
    delta = (gf * out.to(f32).reshape(b, hkv, g, sq, d)).sum(dim=-1)
    u = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    s = softcap_fn(u, softcap) if softcap > 0 else u
    mask = _mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                 skv_valid=skv, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse5[..., None])
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gf, vf)
    ds = p * (dp - delta[..., None])
    if softcap > 0:
        ds = ds * softcap_grad(u, softcap)
    ds = torch.where(mask, ds, torch.zeros((), device=q.device))
    p, ds = bf16_terms(p, terms), bf16_terms(ds, terms)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, gf)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_ref(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,              # 0 => unbounded
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    out = attention_bhsd_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
    )
    return out.transpose(1, 2)
