"""Plain PyTorch versions of the swarm kernels.

They run on any device. The CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card:

- :func:`rarest_argmin_ref` follows ``repro.core.piece_selection
  .batched_rarest`` step for step: the lexicographic minimum of
  ``(availability, jitter, piece index)`` over the candidates, ``-1`` for
  a row without one. Availability and jitter are never added, so the pick
  is *index-exact*.

- :func:`select_rows_ref` is the fleet state's selection for one stream,
  the torch composition that ``repro/kernels/swarm/ops.py`` ``_select_jit``
  wraps around the Pallas kernel: the candidates of the rows built from
  the have-matrix, the stream's routing rule and the other stream's
  piece, then :func:`rarest_argmin_ref`.

- :func:`waterfill_ref` is the float32 max-min fixed point of
  ``repro/kernels/swarm/ref.py`` ``waterfill_f32_ref``: the same op order,
  the dummy link slot of infinite capacity, the ``1e-6`` saturation
  tolerance. Eager PyTorch rounds every multiply and add on its own, as
  numpy does, so this version is *bit-exact* with that numpy function and
  the CUDA kernel (which pins its rounding with ``__fmul_rn`` /
  ``__fadd_rn``) is bit-exact with it.

- :func:`waterfill_compact_ref` states the CUDA kernel's way through
  the same fixed point in plain torch, for the tests: each round visits
  only the list of active flows and the constraint slots they touch, and
  is bit-identical to :func:`waterfill_ref`.

The float64 goldens semantics stay :func:`repro_torch.core.fleet
.waterfill_rates`, the port's copy of the engine's numpy water-fill.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.piece_selection import MAX_EXACT_AVAILABILITY

F32 = torch.float32


def rarest_argmin_ref(
    cand: torch.Tensor, avail: torch.Tensor, jitter: torch.Tensor
) -> torch.Tensor:
    """``(k, P)`` bool candidates, ``(P,)`` availability, ``(k, P)`` float32
    jitter -> ``(k,)`` int32 picks (``-1`` = no candidate)."""
    k, P = cand.shape
    if k == 0 or P == 0:
        return torch.full((k,), -1, dtype=torch.int32, device=cand.device)
    if int(avail.max()) >= MAX_EXACT_AVAILABILITY:
        raise ValueError(
            "replica counts no longer exact in float32 — fleet too large"
        )
    inf = torch.tensor(float("inf"), dtype=F32, device=cand.device)
    score = torch.where(cand, avail.to(F32)[None, :], inf)
    rowmin = score.amin(dim=1, keepdim=True)
    empty = torch.isinf(rowmin[:, 0])
    # minimal-availability slots take their jitter (< 1); every other
    # candidate keeps availability >= rowmin + 1 > jitter, so the argmin
    # (first occurrence) lands on the smallest jitter among the rarest
    score = torch.where(score == rowmin, jitter, score)
    pick = score.argmin(dim=1).to(torch.int32)
    return torch.where(empty, torch.full_like(pick, -1), pick)


def select_rows_ref(
    have: torch.Tensor,
    jitter: torch.Tensor,
    repl: torch.Tensor,
    swarm_class: torch.Tensor,
    rows: torch.Tensor,
    other: torch.Tensor,
    *,
    stream: str,
    mode: str,
    fallback: bool,
) -> torch.Tensor:
    """Piece picks for ``rows`` on one stream: ``(n, P)`` bool ``have``,
    ``(n, P)`` float32 ``jitter``, ``(P,)`` int32 replica counts ``repl``,
    ``(P,)`` bool ``swarm_class``, ``(k,)`` int64 ``rows`` and ``other``
    (the row's piece on its other stream, ``-1`` for none) -> ``(k,)``
    int32 picks, index-exact with ``FleetSwarmSim._select``'s numpy
    candidate build and ``batched_rarest``."""
    P = have.shape[1]
    miss = ~have[rows]  # (k, P)
    sc = swarm_class[None, :]
    if stream == "http":
        if mode == "http_first":
            cand = miss
        else:
            cand = miss & ~sc
            if fallback:
                # origin rescue for swarm-routed pieces nobody serves
                cand = cand | (miss & sc & (repl == 0)[None, :])
    else:
        cand = miss & sc & (repl > 0)[None, :]
    # a peer's two streams exclude each other's current piece
    pid = torch.arange(P, device=have.device)
    cand = cand & ~(pid[None, :] == other[:, None])
    return rarest_argmin_ref(
        cand.contiguous(), repl.to(F32), jitter[rows]
    )


def link_channel(nf: int, link_of=None, link_cap=None):
    """``(nl, lnk, lcap)`` as numpy: unlinked flows map onto a dummy slot
    ``nl`` of infinite capacity, so the link channel always exists and
    every path takes the same branches (``repro/kernels/swarm/ref.py``
    ``_link_channel``)."""
    nl = 0
    if link_of is not None and link_cap is not None:
        link_of = np.asarray(link_of, dtype=np.int64)
        if (link_of >= 0).any():
            nl = np.asarray(link_cap).size
    if nl:
        lnk = np.where(link_of >= 0, link_of, nl)
        lcap = np.concatenate(
            [np.asarray(link_cap, dtype=np.float32), [np.float32(np.inf)]]
        )
    else:
        lnk = np.zeros(nf, dtype=np.int64)
        lcap = np.array([np.inf], dtype=np.float32)
    return nl, lnk, lcap


def waterfill_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    lnk: torch.Tensor,
    up: torch.Tensor,
    dn: torch.Tensor,
    lcap: torch.Tensor,
    active_counts: list | None = None,
) -> tuple[torch.Tensor, int]:
    """Flow table -> ``((nf,) float32 rates, rounds)``.

    ``src``/``dst``/``lnk`` are per-flow node and link-slot indices
    (``src = dst = -1`` marks a padding flow, pre-frozen at rate 0; ``lnk``
    already maps unlinked flows to the dummy slot). ``up``/``dn`` are the
    float32 node capacities, ``lcap`` the link capacities with the dummy
    slot last. ``rounds`` counts the filling rounds that found an active
    flow, as the CUDA kernel and the Pallas kernel count them. A list
    passed as ``active_counts`` is extended by each round's active-flow
    count.
    """
    nf = src.numel()
    dev = src.device
    rate = torch.zeros(nf, dtype=F32, device=dev)
    if nf == 0:
        return rate, 0
    src = src.long()
    dst = dst.long()
    lnk = lnk.long()
    nn = up.numel()
    nlp = lcap.numel()
    frozen = src < 0
    s_safe = src.clamp_min(0)
    d_safe = dst.clamp_min(0)
    up_a = torch.zeros(nn, dtype=F32, device=dev)
    dn_a = torch.zeros(nn, dtype=F32, device=dev)
    lk_a = torch.zeros(nlp, dtype=F32, device=dev)
    inf = torch.tensor(float("inf"), dtype=F32, device=dev)
    eps = torch.tensor(1e-6, dtype=F32, device=dev)
    rounds = 0
    for _ in range(2 * nn + (nlp - 1) + 2):  # >= 1 constraint per round
        active = ~frozen
        if not bool(active.any()):
            break
        rounds += 1
        if active_counts is not None:
            active_counts.append(int(active.sum()))
        n_up = torch.bincount(src[active], minlength=nn).to(F32)
        n_dn = torch.bincount(dst[active], minlength=nn).to(F32)
        n_lk = torch.bincount(lnk[active], minlength=nlp).to(F32)
        du = torch.where(n_up > 0, (up - up_a) / n_up, inf)
        dd = torch.where(n_dn > 0, (dn - dn_a) / n_dn, inf)
        dl = torch.where(n_lk > 0, (lcap - lk_a) / n_lk, inf)
        delta = torch.minimum(torch.minimum(du.min(), dd.min()), dl.min())
        if not bool(torch.isfinite(delta)):
            break
        delta = torch.clamp_min(delta, 0.0)
        rate = torch.where(active, rate + delta, rate)
        up_a = up_a + n_up * delta
        dn_a = dn_a + n_dn * delta
        lk_a = lk_a + n_lk * delta
        tol = delta + eps
        sat_u = (du <= tol) & (n_up > 0)
        sat_d = (dd <= tol) & (n_dn > 0)
        sat_l = (dl <= tol) & (n_lk > 0)
        newly = active & (sat_u[s_safe] | sat_d[d_safe] | sat_l[lnk])
        if not bool(newly.any()):
            break
        frozen = frozen | newly
    return rate, rounds



def waterfill_compact_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    lnk: torch.Tensor,
    up: torch.Tensor,
    dn: torch.Tensor,
    lcap: torch.Tensor,
    active_counts: list | None = None,
    touched_counts: list | None = None,
) -> tuple[torch.Tensor, int]:
    """:func:`waterfill_ref`'s contract, computed as the CUDA kernel
    computes it: a round visits its list of active flows and the
    constraint slots they touch (one vector ``2 nn + nlp`` long: uplinks,
    downlinks, link slots), never the whole table. A list passed as
    ``touched_counts`` is extended by each round's touched slots. An untouched slot is
    what the plain version leaves it: count 0 gives ``d = inf``, which
    never lowers the minimum; ``alloc + 0 * delta`` is ``alloc`` bit for
    bit (``delta`` finite and ``>= 0``, ``alloc >= +0``); and it never
    saturates."""
    nf = src.numel()
    dev = src.device
    rate = torch.zeros(nf, dtype=F32, device=dev)
    if nf == 0:
        return rate, 0
    nn = up.numel()
    nlp = lcap.numel()
    cap = torch.cat([up, dn, lcap])
    slots = torch.stack([src.long(), nn + dst.long(), 2 * nn + lnk.long()], 1)
    alloc = torch.zeros(cap.numel(), dtype=F32, device=dev)
    saturated = torch.zeros(cap.numel(), dtype=torch.bool, device=dev)
    eps = torch.tensor(1e-6, dtype=F32, device=dev)
    live = torch.nonzero(src >= 0)[:, 0]  # padding flows pre-frozen at 0
    rounds = 0
    for _ in range(2 * nn + (nlp - 1) + 2):
        if live.numel() == 0:
            break
        rounds += 1
        if active_counts is not None:
            active_counts.append(live.numel())
        touched, count = torch.unique(slots[live], return_counts=True)
        if touched_counts is not None:
            touched_counts.append(touched.numel())
        count = count.to(F32)
        d = (cap[touched] - alloc[touched]) / count
        delta = d.min()
        if not bool(torch.isfinite(delta)):
            break
        delta = torch.clamp_min(delta, 0.0)
        rate[live] = rate[live] + delta
        alloc[touched] = alloc[touched] + count * delta
        saturated[touched] = d <= delta + eps
        stay = ~saturated[slots[live]].any(dim=1)
        saturated[touched] = False
        if bool(stay.all()):
            break
        live = live[stay]
    return rate, rounds
