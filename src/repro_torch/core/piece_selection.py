"""Piece-selection policies.

Rarest-first is what makes the paper's U/D economics work: by preferentially
replicating the globally scarcest piece, the swarm maximizes source
diversity, so the origin seeder only has to upload each piece ~once before
the community can amplify it (Eq. 1's 42×). We also provide ``sequential``
(streaming ingest for the training data pipeline, where shard order matters)
and ``random_first`` (BitTorrent's bootstrap heuristic), plus **endgame
mode** — duplicate requests for the final in-flight pieces, which is the
fabric-level straggler mitigation (DESIGN.md §8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .bitfield import Bitfield


def candidate_pieces(
    mine: Bitfield,
    remote: Bitfield,
    in_flight: set[int],
) -> np.ndarray:
    """Pieces ``remote`` can serve that we neither hold nor have requested."""
    cand = remote.as_array() & ~mine.as_array()
    if in_flight:
        cand = cand.copy()
        cand[np.fromiter(in_flight, dtype=np.int64)] = False
    return np.flatnonzero(cand)


def rarest_among(
    cand: np.ndarray, availability: np.ndarray, rng: np.random.Generator
) -> int:
    """Min-availability filter over ``cand`` plus one uniform tie-break draw.

    The shared tie-break kernel for every rarest-first path (peer planning,
    masked partitioned-ingest selection): deterministic given the candidate
    set, the availability vector, and the RNG state — equal-availability
    ties consume exactly one ``rng.integers`` draw, so two schedulers with
    the same seed make identical sequences of choices.
    """
    avail = availability[cand]
    best = cand[avail == avail.min()]
    return int(best[rng.integers(len(best))])


def rarest_first(
    mine: Bitfield,
    remote: Bitfield,
    availability: np.ndarray,
    in_flight: set[int],
    rng: np.random.Generator,
) -> Optional[int]:
    """Pick the candidate piece with minimal swarm availability.

    Ties are broken uniformly at random (the BitTorrent behaviour) — without
    random tie-breaks every leecher converges on the same piece and the
    swarm serializes behind one uploader.
    """
    cand = candidate_pieces(mine, remote, in_flight)
    if cand.size == 0:
        return None
    return rarest_among(cand, availability, rng)


def sequential(
    mine: Bitfield,
    remote: Bitfield,
    availability: np.ndarray,
    in_flight: set[int],
    rng: np.random.Generator,
) -> Optional[int]:
    """Lowest-index candidate — streaming order for pipeline ingest."""
    del availability, rng
    cand = candidate_pieces(mine, remote, in_flight)
    return int(cand[0]) if cand.size else None


def random_first(
    mine: Bitfield,
    remote: Bitfield,
    availability: np.ndarray,
    in_flight: set[int],
    rng: np.random.Generator,
) -> Optional[int]:
    """Uniform-random candidate (bootstrap: get *something* to trade fast)."""
    del availability
    cand = candidate_pieces(mine, remote, in_flight)
    if cand.size == 0:
        return None
    return int(cand[rng.integers(cand.size)])


#: :func:`batched_rarest` scores in float32, so replica counts must stay
#: exactly representable there. Counts are integers bounded by the fleet
#: size, so anything below ``2**24`` round-trips through float32 exactly
#: (and the 10⁵–10⁶ fleets this engine targets sit well under the bound).
MAX_EXACT_AVAILABILITY = 1 << 24


def batched_rarest(
    cand: np.ndarray, availability: np.ndarray, jitter: np.ndarray
) -> np.ndarray:
    """Rarest-first selection for a whole batch of peers at once.

    The fleet engine's vectorized counterpart of :func:`rarest_among`:
    ``cand`` is a ``(k, P)`` bool matrix (candidate pieces per selecting
    peer), ``availability`` the shared ``(P,)`` replica counts, ``jitter``
    a ``(k, P)`` float32 matrix of per-(peer, piece) tie-break values in
    ``[0, 1)``. The winner is the lexicographic minimum of
    ``(availability, jitter, piece index)`` over the candidate set: the
    jitter (strictly below 1) only breaks equal-availability ties, and is
    fixed per peer rather than redrawn, so selection costs no per-tick
    RNG. Returns a ``(k,)`` piece index vector, ``-1`` where a peer has
    no candidate.

    The whole computation stays in float32 — the one ``(k, P)`` score
    allocation is half what the former float64 sum cost. That is safe
    because the two stages never *add* availability to jitter (a float32
    sum would round the jitter away above small counts): availability is
    an integer below :data:`MAX_EXACT_AVAILABILITY` (asserted), hence
    exact in float32, and the jitter matrix is already float32, so the
    two-stage argmin picks the identical index the exact float64
    ``availability + jitter`` argmin would — equal-availability and
    equal-jitter ties still resolve to the lowest piece index.
    """
    assert int(availability.max(initial=0)) < MAX_EXACT_AVAILABILITY, (
        "replica counts no longer exact in float32 — fleet too large"
    )
    score = np.where(
        cand, availability.astype(np.float32), np.float32(np.inf)
    )                                        # the one (k, P) allocation
    rowmin = score.min(axis=1, keepdims=True)
    empty = ~np.isfinite(rowmin[:, 0])       # before jitter overwrites inf
    # minimal-availability slots get their jitter (< 1); every other
    # candidate keeps availability >= rowmin + 1 > jitter, so the argmin
    # lands on the smallest jitter among the rarest candidates
    np.copyto(score, jitter, where=score == rowmin)
    pick = score.argmin(axis=1).astype(np.int64)
    pick[empty] = -1
    return pick


POLICIES = {
    "rarest_first": rarest_first,
    "sequential": sequential,
    "random_first": random_first,
}


def select_piece(
    policy: str,
    mine: Bitfield,
    remote: Bitfield,
    availability: np.ndarray,
    in_flight: set[int],
    rng: np.random.Generator,
    pieces_held: int = 0,
    random_bootstrap: int = 4,
) -> Optional[int]:
    """Dispatch with the standard bootstrap hybrid: the first few pieces are
    chosen at random (fast trade currency), then the policy takes over."""
    if policy == "rarest_first" and pieces_held < random_bootstrap:
        got = random_first(mine, remote, availability, in_flight, rng)
        if got is not None:
            return got
    return POLICIES[policy](mine, remote, availability, in_flight, rng)


def endgame_candidates(
    mine: Bitfield,
    remote: Bitfield,
    duplicated: set[int],
) -> np.ndarray:
    """In endgame, everything missing (even if in flight) is fair game except
    pieces we've already duplicated to this degree."""
    cand = remote.as_array() & ~mine.as_array()
    if duplicated:
        cand = cand.copy()
        cand[np.fromiter(duplicated, dtype=np.int64)] = False
    return np.flatnonzero(cand)


def in_endgame(mine: Bitfield, in_flight: set[int], threshold: float = 1.0) -> bool:
    """Endgame once every missing piece is already requested (classic rule),
    or — with threshold<1 — once the missing set is small enough."""
    missing = len(mine) - mine.count()
    if missing == 0:
        return False
    covered = sum(1 for p in in_flight if not mine.has(p))
    return covered >= missing * threshold
