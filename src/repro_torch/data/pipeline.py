"""Token batch pipeline: shard tokens -> shuffled fixed-length batches.

Deterministic and exactly resumable: the whole pipeline state is
:class:`DataState` (epoch, cursor, seed) — three integers that go into every
checkpoint. Reconstructing a pipeline from a restored DataState yields the
identical remaining batch stream (asserted by tests), which is what makes
checkpoint/restart bitwise-reproducible end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataState:
    epoch: int = 0
    cursor: int = 0          # batches already emitted within the epoch
    shuffle_seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Batch:
    """One global batch (host slice): next-token prediction pairs."""

    tokens: np.ndarray   # (batch, seq) int32 inputs
    targets: np.ndarray  # (batch, seq) int32 labels (inputs shifted left)

    @property
    def shape(self) -> tuple[int, int]:
        return self.tokens.shape  # type: ignore[return-value]


class HostBatcher:
    """Batches one host's shard tokens. ``seq_len+1`` windows give
    (input, target) pairs; window order is reshuffled every epoch."""

    def __init__(
        self,
        shard_tokens: Sequence[np.ndarray],
        batch_size: int,
        seq_len: int,
        state: Optional[DataState] = None,
        drop_remainder: bool = True,
    ):
        if not shard_tokens:
            raise ValueError("no shards given")
        self.tokens = np.concatenate([np.asarray(s) for s in shard_tokens])
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.state = state or DataState()
        window = seq_len + 1
        self.num_windows = len(self.tokens) // window
        if self.num_windows < batch_size and drop_remainder:
            raise ValueError(
                f"corpus too small: {self.num_windows} windows < batch {batch_size}"
            )
        self.batches_per_epoch = self.num_windows // batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.state.shuffle_seed + 7919 * epoch)
        return rng.permutation(self.num_windows)

    def _make_batch(self, order: np.ndarray, cursor: int) -> Batch:
        idx = order[cursor * self.batch_size : (cursor + 1) * self.batch_size]
        window = self.seq_len + 1
        rows = np.stack([self.tokens[i * window : (i + 1) * window] for i in idx])
        return Batch(tokens=rows[:, :-1].astype(np.int32),
                     targets=rows[:, 1:].astype(np.int32))

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(self.state)

    def iter_from(self, state: DataState) -> Iterator[Batch]:
        """Yield batches starting exactly at ``state`` (mutates self.state)."""
        self.state = dataclasses.replace(state)
        while True:
            order = self._epoch_order(self.state.epoch)
            while self.state.cursor < self.batches_per_epoch:
                batch = self._make_batch(order, self.state.cursor)
                self.state.cursor += 1
                yield batch
            self.state.epoch += 1
            self.state.cursor = 0

    def take(self, n: int) -> list[Batch]:
        it = iter(self)
        return [next(it) for _ in range(n)]


def global_batch_layout(
    global_batch: int, num_hosts: int
) -> tuple[int, int]:
    """(per_host_batch, remainder_check). Global batch must divide evenly —
    at production scale uneven host batches silently skew the loss."""
    if global_batch % num_hosts:
        raise ValueError(f"global batch {global_batch} !% hosts {num_hosts}")
    return global_batch // num_hosts, 0


def prefetch(iterator: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Software pipeline: keep ``depth`` batches materialized ahead of
    consumption. On a real host this hides swarm-ingest and host-to-device
    latency behind step compute; in-process it provides the same interface.
    """
    import collections

    buf: collections.deque[Batch] = collections.deque()
    try:
        for _ in range(depth):
            buf.append(next(iterator))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(next(iterator))
        except StopIteration:
            pass
        yield nxt
