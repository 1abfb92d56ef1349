"""Plain PyTorch version of the chunked SSD (K5).

It runs on any device. The CPU tests hold it against the JAX package's
``repro/models/ssd.py`` ``ssd_chunked`` (of which it is a line-by-line
port), ``repro/kernels/ssd/ref.py`` and the Pallas kernel, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

Two forms:

- :func:`ssd_chunked_ref` in the model's ``(B, S, H, P)`` layout, the
  counterpart of ``ssd_chunked``: an optional initial state ``h0``,
  returning ``(y, h_last)`` in float32;
- :func:`ssd_ref` in the ``(B, H, S, P)`` layout of the Pallas kernel,
  the counterpart of ``repro/kernels/ssd/ref.py`` ``ssd_ref``.

Beside them, :func:`ssd_chunked_split_ref` states the arithmetic of K5's
bfloat16 (tensor-core) route in plain torch, for the CPU tests that
rehearse it and, with its float32 operands unsplit, as the control that
the card's band must leave outside.

Everything is float32 inside (float64 on request). The sequence is zero-padded to a multiple of
the chunk, and a padded row has ``dt = 0``: it adds nothing to the state
and decays nothing, so ``h_last`` is the state after the last real row.
Within a chunk the quadratic (attention-like) dual form runs as einsums over
``(Q, Q)`` score tiles; across chunks a Python loop carries the state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: ``out[..., i, j] =
    sum_{j < t <= i} a[..., t]``; ``-inf`` above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(
    x: torch.Tensor,        # (B, S, H, P) raw inputs
    dt: torch.Tensor,       # (B, S, H) positive step sizes
    a_neg: torch.Tensor,    # (H,) negative per-head decay rates
    bmat: torch.Tensor,     # (B, S, N)
    cmat: torch.Tensor,     # (B, S, N)
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N) initial state
    *,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, H, P), h_last (B, H, P, N))``, computed in
    ``dtype``: float32, or float64 to see how far float32 is from exact."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (s + pad) // chunk

    ft = dtype
    xf = x.to(ft).reshape(b, nc, chunk, h, p)
    dtf = dt.to(ft).reshape(b, nc, chunk, h)
    bf = bmat.to(ft).reshape(b, nc, chunk, n)
    cf = cmat.to(ft).reshape(b, nc, chunk, n)
    a = dtf * a_neg.to(ft)                        # (B,NC,Q,H) log-decay <= 0
    xdt = xf * dtf[..., None]

    a_t = a.transpose(2, 3)                       # (B,NC,H,Q)
    acum = torch.cumsum(a_t, dim=-1)              # within-chunk cumulative

    # intra-chunk dual (quadratic) form
    l_mat = torch.exp(_segsum(a_t))               # (B,NC,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)[:, :, None] * l_mat
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # per-chunk input states
    decay_states = torch.exp(acum[..., -1:] - acum)   # (B,NC,H,Q)
    states = torch.einsum("bcqn,bchq,bcqhp->bchpn", bf, decay_states, xdt)

    # inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(acum[..., -1])        # (B,NC,H)
    carry = (torch.zeros((b, h, p, n), dtype=ft, device=x.device)
             if h0 is None else h0.to(ft))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(entering, dim=1)         # (B,NC,H,P,N)

    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", cf, h_prev, torch.exp(acum))
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, carry


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
            bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
            ) -> torch.Tensor:
    """The Pallas kernel's layout: x ``(B, H, S, P)``, dt ``(B, H, S)``,
    a_neg ``(H,)`` -> y ``(B, H, S, P)`` float32."""
    y, _ = ssd_chunked_ref(x.transpose(1, 2), dt.transpose(1, 2), a_neg,
                           bmat, cmat, chunk)
    return y.transpose(1, 2)


#: bf16 terms of K5's float32 operands on the tensor cores: S ⊙ L ⊙ dt_j,
#: x ⊙ w and h_prev
SPLIT_TERMS = (3, 3, 3)


def _bf16_parts(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``v`` as ``terms`` bf16-valued float32 terms: bf16(v), then bf16 of
    what is left, and so on."""
    parts = []
    for _ in range(terms):
        part = v.to(torch.bfloat16).to(torch.float32)
        parts.append(part)
        v = v - part
    return parts


def ssd_chunked_split_ref(
    x: torch.Tensor,        # (B, S, H, P), bfloat16 values
    dt: torch.Tensor,       # (B, S, H)
    a_neg: torch.Tensor,    # (H,)
    bmat: torch.Tensor,     # (B, S, N), bfloat16 values
    cmat: torch.Tensor,     # (B, S, N), bfloat16 values
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
    *,
    terms: tuple[int, int, int] = SPLIT_TERMS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's tensor-core arithmetic: ``(y (B, S, H, P), h_last (B, H, P,
    N))`` in float32, as :func:`ssd_chunked_ref` computes them, with every
    product given one bf16 operand and one float32 operand cut into bf16
    terms, each multiplied in float32 and the products summed: S = C Bᵀ
    from bf16 operands; y = (S ⊙ L ⊙ dt_j) x + exp(acum) ⊙ (C h_prevᵀ);
    the chunk's state (x ⊙ w)ᵀ B with w_j = dt_j exp(acum[-1] - acum_j),
    scanned over the chunks apart. x, B and C are rounded to bfloat16
    first, as the route takes them. ``terms`` gives the bf16 terms of S ⊙
    L ⊙ dt_j, x ⊙ w and h_prev: ``SPLIT_TERMS`` is the kernel's, ``(1, 1,
    1)`` feeds each float32 operand to the tensor cores as one bf16
    term."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (s + pad) // chunk

    f32 = torch.float32

    def bf16_values(t):
        return t.to(torch.bfloat16).to(f32)

    xf = bf16_values(x).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h).transpose(2, 3)   # (B,NC,H,Q)
    bf = bf16_values(bmat).reshape(b, nc, chunk, n)
    cf = bf16_values(cmat).reshape(b, nc, chunk, n)
    a_t = dtf * a_neg.to(f32)[:, None]
    acum = torch.cumsum(a_t, dim=-1)

    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)[:, :, None]
    weighted = scores * torch.exp(_segsum(a_t)) * dtf[..., None, :]
    y_diag = sum(torch.einsum("bchij,bcjhp->bcihp", part, xf)
                 for part in _bf16_parts(weighted, terms[0]))

    w = dtf * torch.exp(acum[..., -1:] - acum)                  # (B,NC,H,Q)
    xw = xf * w.transpose(2, 3)[..., None]                      # (B,NC,Q,H,P)
    states = sum(torch.einsum("bcqhp,bcqn->bchpn", part, bf)
                 for part in _bf16_parts(xw, terms[1]))

    chunk_decay = torch.exp(acum[..., -1])
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(entering, dim=1)                       # (B,NC,H,P,N)

    y_off = sum(torch.einsum("bcqn,bchpn->bchqp", cf, part)
                for part in _bf16_parts(h_prev, terms[2]))
    y_off = (y_off * torch.exp(acum)[..., None]).transpose(2, 3)
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, carry
