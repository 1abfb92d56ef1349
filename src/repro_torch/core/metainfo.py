"""Content-addressed piece tables ("torrents") for datasets and checkpoints.

This is the paper's `.torrent` artifact: a dataset (or checkpoint bundle) is
split into fixed-size pieces, each identified by a cryptographic hash. Any
peer holding a verified piece can re-serve it; the hash table is the root of
trust that lets the swarm accept bytes from untrusted-order sources.

Academic Torrents uses BitTorrent metainfo (SHA-1); we use SHA-256 (see
DESIGN.md §6) and add a stable ``info_hash`` so a checkpoint bundle is
content-addressed end-to-end.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Iterator, Sequence

_HASH = hashlib.sha256
HASH_LEN = 32


def piece_hash(data: bytes) -> bytes:
    return _HASH(data).digest()


@dataclasses.dataclass(frozen=True)
class FileEntry:
    """One logical file inside a bundle (dataset shard, checkpoint array)."""

    name: str
    length: int
    offset: int  # byte offset within the concatenated bundle


@dataclasses.dataclass(frozen=True)
class MetaInfo:
    """Immutable piece table for one distributable bundle.

    Attributes:
      name: human-readable bundle name (e.g. ``reddit_comments_2015``).
      piece_length: bytes per piece (last piece may be short).
      length: total bundle length in bytes.
      piece_hashes: SHA-256 digest per piece, in order.
      files: logical file layout within the bundle.
    """

    name: str
    piece_length: int
    length: int
    piece_hashes: tuple[bytes, ...]
    files: tuple[FileEntry, ...] = ()

    def __post_init__(self) -> None:
        if self.piece_length <= 0:
            raise ValueError("piece_length must be positive")
        if self.length < 0:
            raise ValueError("length must be non-negative")
        expect = max(1, -(-self.length // self.piece_length)) if self.length else 0
        if self.length and len(self.piece_hashes) != expect:
            raise ValueError(
                f"piece table has {len(self.piece_hashes)} entries, expected {expect}"
            )

    # ------------------------------------------------------------------ sizes
    @property
    def num_pieces(self) -> int:
        return len(self.piece_hashes)

    def piece_size(self, index: int) -> int:
        """Size in bytes of piece ``index`` (the tail piece may be short)."""
        self._check_index(index)
        if index == self.num_pieces - 1:
            rem = self.length - self.piece_length * (self.num_pieces - 1)
            return rem if rem else self.piece_length
        return self.piece_length

    def piece_span(self, index: int) -> tuple[int, int]:
        """(start, end) byte offsets of piece ``index`` within the bundle."""
        self._check_index(index)
        start = index * self.piece_length
        return start, start + self.piece_size(index)

    def _check_index(self, index: int) -> None:
        if not 0 <= index < self.num_pieces:
            raise IndexError(f"piece index {index} out of range [0, {self.num_pieces})")

    # ------------------------------------------------------------- verification
    def verify_piece(self, index: int, data: bytes) -> bool:
        """True iff ``data`` is exactly piece ``index`` (size and hash match)."""
        self._check_index(index)
        if len(data) != self.piece_size(index):
            return False
        return piece_hash(data) == self.piece_hashes[index]

    # ------------------------------------------------------------- identity
    @property
    def info_hash(self) -> bytes:
        payload = json.dumps(
            {
                "name": self.name,
                "piece_length": self.piece_length,
                "length": self.length,
                "pieces": [h.hex() for h in self.piece_hashes],
                "files": [(f.name, f.length, f.offset) for f in self.files],
            },
            sort_keys=True,
        ).encode()
        return _HASH(payload).digest()

    @property
    def info_hash_hex(self) -> str:
        return self.info_hash.hex()

    # ------------------------------------------------------------- builders
    @classmethod
    def from_bytes(
        cls, data: bytes, piece_length: int, name: str = "bundle"
    ) -> "MetaInfo":
        hashes = tuple(
            piece_hash(data[i : i + piece_length])
            for i in range(0, max(len(data), 1), piece_length)
        )
        if not data:
            hashes = ()
        return cls(
            name=name,
            piece_length=piece_length,
            length=len(data),
            piece_hashes=hashes,
            files=(FileEntry(name, len(data), 0),),
        )

    @classmethod
    def from_named_blobs(
        cls,
        blobs: Sequence[tuple[str, bytes]],
        piece_length: int,
        name: str = "bundle",
    ) -> tuple["MetaInfo", bytes]:
        """Build a multi-file bundle; returns (metainfo, concatenated payload)."""
        files = []
        offset = 0
        chunks = []
        for fname, data in blobs:
            files.append(FileEntry(fname, len(data), offset))
            offset += len(data)
            chunks.append(data)
        payload = b"".join(chunks)
        mi = cls.from_bytes(payload, piece_length, name=name)
        return dataclasses.replace(mi, files=tuple(files)), payload

    @classmethod
    def from_sizes_only(
        cls, length: int, piece_length: int, name: str = "bundle", seed: int = 0
    ) -> "MetaInfo":
        """A metainfo with synthetic (deterministic) hashes for *size-only*
        simulation, where no real payload bytes exist (netsim benchmarks of
        multi-TB datasets). The hashes are derived from (name, seed, index) so
        two size-only metainfos agree iff their identity agrees.
        """
        n = max(1, -(-length // piece_length)) if length else 0
        hashes = tuple(
            _HASH(f"{name}:{seed}:{i}".encode()).digest() for i in range(n)
        )
        return cls(name=name, piece_length=piece_length, length=length, piece_hashes=hashes)

    # ------------------------------------------------------------- payload ops
    def split_pieces(self, payload: bytes) -> Iterator[tuple[int, bytes]]:
        if len(payload) != self.length:
            raise ValueError("payload length mismatch")
        for i in range(self.num_pieces):
            s, e = self.piece_span(i)
            yield i, payload[s:e]

    def extract_file(self, payload: bytes, name: str) -> bytes:
        for f in self.files:
            if f.name == name:
                return payload[f.offset : f.offset + f.length]
        raise KeyError(name)

    # ------------------------------------------------------------- (de)serialise
    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "piece_length": self.piece_length,
                "length": self.length,
                "piece_hashes": [h.hex() for h in self.piece_hashes],
                "files": [(f.name, f.length, f.offset) for f in self.files],
            }
        )

    @classmethod
    def from_json(cls, text: str) -> "MetaInfo":
        d = json.loads(text)
        return cls(
            name=d["name"],
            piece_length=d["piece_length"],
            length=d["length"],
            piece_hashes=tuple(bytes.fromhex(h) for h in d["piece_hashes"]),
            files=tuple(FileEntry(*f) for f in d["files"]),
        )


def assemble(metainfo: MetaInfo, pieces: dict[int, bytes]) -> bytes:
    """Reassemble and verify a complete bundle from its pieces."""
    out = []
    for i in range(metainfo.num_pieces):
        if i not in pieces:
            raise KeyError(f"missing piece {i}")
        if not metainfo.verify_piece(i, pieces[i]):
            raise ValueError(f"piece {i} failed verification")
        out.append(pieces[i])
    return b"".join(out)
