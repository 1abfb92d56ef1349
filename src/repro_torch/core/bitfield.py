"""Piece-possession bitfields.

A peer's bitfield is the wire-visible summary of which pieces it can serve.
Backed by a numpy bool array; all mutation is explicit, all set algebra is
vectorized (swarms track availability across hundreds of peers × thousands
of pieces).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np


class Bitfield:
    __slots__ = ("_bits", "version")

    def __init__(self, num_pieces: int, bits: np.ndarray | None = None):
        if bits is not None:
            if bits.shape != (num_pieces,):
                raise ValueError("bits shape mismatch")
            self._bits = bits.astype(bool).copy()
        else:
            self._bits = np.zeros(num_pieces, dtype=bool)
        # bumped on every mutation; lets observers (the tracker's
        # incremental availability map) detect in-place changes cheaply
        self.version = 0

    # ------------------------------------------------------------- constructors
    @classmethod
    def full(cls, num_pieces: int) -> "Bitfield":
        bf = cls(num_pieces)
        bf._bits[:] = True
        return bf

    @classmethod
    def from_indices(cls, num_pieces: int, indices: Iterable[int]) -> "Bitfield":
        bf = cls(num_pieces)
        idx = list(indices)
        if idx:
            bf._bits[np.asarray(idx, dtype=np.int64)] = True
        return bf

    def copy(self) -> "Bitfield":
        return Bitfield(len(self._bits), self._bits)

    # ------------------------------------------------------------- mutation
    def set(self, index: int) -> None:
        self._bits[index] = True
        self.version += 1

    def clear(self, index: int) -> None:
        self._bits[index] = False
        self.version += 1

    # ------------------------------------------------------------- queries
    def __contains__(self, index: int) -> bool:
        return bool(self._bits[index])

    def has(self, index: int) -> bool:
        return bool(self._bits[index])

    def count(self) -> int:
        return int(self._bits.sum())

    def __len__(self) -> int:
        return len(self._bits)

    @property
    def complete(self) -> bool:
        return bool(self._bits.all())

    @property
    def empty(self) -> bool:
        return not self._bits.any()

    def indices(self) -> np.ndarray:
        return np.flatnonzero(self._bits)

    def missing(self) -> np.ndarray:
        return np.flatnonzero(~self._bits)

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())

    # ------------------------------------------------------------- set algebra
    def as_array(self) -> np.ndarray:
        """Read-only view (do not mutate)."""
        return self._bits

    def missing_from(self, other: "Bitfield") -> np.ndarray:
        """Pieces ``other`` has that we lack — the 'interesting' set."""
        return np.flatnonzero(other._bits & ~self._bits)

    def interested_in(self, other: "Bitfield") -> bool:
        return bool((other._bits & ~self._bits).any())

    def fraction(self) -> float:
        return float(self._bits.mean()) if len(self._bits) else 1.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Bitfield({self.count()}/{len(self)})"


def availability(bitfields: Iterable[Bitfield], num_pieces: int) -> np.ndarray:
    """Per-piece replica count across a set of peers (rarest-first input)."""
    acc = np.zeros(num_pieces, dtype=np.int64)
    for bf in bitfields:
        acc += bf.as_array()
    return acc
