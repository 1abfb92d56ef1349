"""Sharded synthetic corpus whose manifest *is* a torrent.

A dataset is N shards of packed int32 tokens. The distributable artifact is
the concatenated shard payload plus a :class:`~repro_torch.core.MetaInfo` piece
table (one `FileEntry` per shard), so "publish a dataset" == "seed its
metainfo" — the paper's model, applied to training data.

Shard payloads are generated deterministically from (seed, shard_index):
any host can *verify* shards it received through the swarm against the
manifest, and tests can regenerate ground truth independently.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator

import numpy as np

from ..core.metainfo import FileEntry, MetaInfo

TOKEN_DTYPE = np.int32


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.tokens"


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Identity of a synthetic corpus."""

    name: str = "synthetic"
    num_shards: int = 16
    tokens_per_shard: int = 1 << 16
    vocab_size: int = 259
    seed: int = 0
    piece_length: int = 1 << 18  # 256 KiB pieces by default

    @property
    def shard_bytes(self) -> int:
        return self.tokens_per_shard * TOKEN_DTYPE().itemsize

    @property
    def total_tokens(self) -> int:
        return self.num_shards * self.tokens_per_shard


def generate_shard(spec: CorpusSpec, index: int) -> np.ndarray:
    """Deterministic pseudo-text tokens for shard ``index``.

    A Markov-ish mixture (not uniform noise) so language models actually
    have structure to learn in end-to-end training tests.
    """
    if not 0 <= index < spec.num_shards:
        raise IndexError(index)
    rng = np.random.default_rng(
        zlib.crc32(f"{spec.name}:{spec.seed}:{index}".encode())
    )
    n = spec.tokens_per_shard
    v = spec.vocab_size
    # biased unigram base
    logits = rng.normal(size=v)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    base = rng.choice(v, size=n, p=probs).astype(TOKEN_DTYPE)
    # inject copy structure: token[i] = token[i-k] on random spans
    span = rng.integers(8, 64)
    starts = rng.choice(n - 2 * span, size=max(n // (span * 4), 1), replace=False)
    for s in starts:
        base[s + span : s + 2 * span] = base[s : s + span]
    return base % v


def shard_to_bytes(tokens: np.ndarray) -> bytes:
    return tokens.astype(TOKEN_DTYPE).tobytes()


def bytes_to_shard(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=TOKEN_DTYPE).copy()


class ShardedCorpus:
    """Materialized corpus + manifest. The origin side of the swarm."""

    def __init__(self, spec: CorpusSpec):
        self.spec = spec
        self._payloads = [
            shard_to_bytes(generate_shard(spec, i)) for i in range(spec.num_shards)
        ]
        blobs = [(_shard_name(i), p) for i, p in enumerate(self._payloads)]
        self.manifest, self.payload = MetaInfo.from_named_blobs(
            blobs, spec.piece_length, name=spec.name
        )

    def shard_payload(self, index: int) -> bytes:
        return self._payloads[index]

    def shard_tokens(self, index: int) -> np.ndarray:
        return bytes_to_shard(self._payloads[index])

    def origin_pieces(self) -> dict[int, bytes]:
        return dict(self.manifest.split_pieces(self.payload))

    def iter_shards(self) -> Iterator[tuple[int, np.ndarray]]:
        for i in range(self.spec.num_shards):
            yield i, self.shard_tokens(i)


def manifest_only(spec: CorpusSpec) -> MetaInfo:
    """Build the manifest without holding all payloads (host side)."""
    return ShardedCorpus(spec).manifest  # small specs only; origin caches anyway


def shard_file_entries(manifest: MetaInfo) -> list[FileEntry]:
    return [f for f in manifest.files if f.name.startswith("shard_")]


def pieces_for_shard(manifest: MetaInfo, entry: FileEntry) -> list[int]:
    """Piece indices overlapping one shard (for windowed/streaming ingest)."""
    first = entry.offset // manifest.piece_length
    last = (entry.offset + entry.length - 1) // manifest.piece_length
    return list(range(first, last + 1))
