"""Content-addressed local piece/shard cache.

Each host holds one store. Keys are piece hashes (hex), so the cache is
self-verifying and resumable: on restart, rescanning the directory restores
exactly the possession bitfield the swarm needs — a crashed host re-joins
the swarm with everything it had durably written (fault tolerance at the
data plane).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..core.bitfield import Bitfield
from ..core.metainfo import MetaInfo, piece_hash


class ShardStore:
    """In-memory store with optional write-through directory persistence."""

    def __init__(self, directory: Optional[str | Path] = None):
        self.directory = Path(directory) if directory is not None else None
        self._mem: dict[str, bytes] = {}
        if self.directory is not None:
            self.directory.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- raw access
    def put(self, data: bytes) -> str:
        key = piece_hash(data).hex()
        if key not in self._mem:
            self._mem[key] = data
            if self.directory is not None:
                tmp = self.directory / f".{key}.tmp"
                tmp.write_bytes(data)
                os.replace(tmp, self.directory / key)  # atomic publish
        return key

    def get(self, key: str) -> Optional[bytes]:
        if key in self._mem:
            return self._mem[key]
        if self.directory is not None:
            path = self.directory / key
            if path.exists():
                data = path.read_bytes()
                if piece_hash(data).hex() == key:  # self-verify on read
                    self._mem[key] = data
                    return data
                path.unlink()  # corrupted at rest: drop, let the swarm re-fetch
        return None

    def has(self, key: str) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return len(self._mem)

    # ------------------------------------------------------------- torrent view
    def put_piece(self, metainfo: MetaInfo, index: int, data: bytes) -> bool:
        if not metainfo.verify_piece(index, data):
            return False
        self.put(data)
        return True

    def get_piece(self, metainfo: MetaInfo, index: int) -> Optional[bytes]:
        return self.get(metainfo.piece_hashes[index].hex())

    def bitfield(self, metainfo: MetaInfo) -> Bitfield:
        """Possession bitfield for a torrent — resumability entry point."""
        bf = Bitfield(metainfo.num_pieces)
        for i, h in enumerate(metainfo.piece_hashes):
            if self.has(h.hex()):
                bf.set(i)
        return bf

    def pieces(self, metainfo: MetaInfo) -> dict[int, bytes]:
        out = {}
        for i, h in enumerate(metainfo.piece_hashes):
            data = self.get(h.hex())
            if data is not None:
                out[i] = data
        return out

    def missing(self, metainfo: MetaInfo) -> list[int]:
        return self.bitfield(metainfo).missing().tolist()

    def extract_file(self, metainfo: MetaInfo, name: str) -> Optional[bytes]:
        """Reassemble one logical file if all its pieces are present."""
        entry = next((f for f in metainfo.files if f.name == name), None)
        if entry is None:
            raise KeyError(name)
        first = entry.offset // metainfo.piece_length
        last = (entry.offset + entry.length - 1) // metainfo.piece_length if entry.length else first
        chunks = []
        for i in range(first, last + 1):
            data = self.get_piece(metainfo, i)
            if data is None:
                return None
            chunks.append(data)
        blob = b"".join(chunks)
        start = entry.offset - first * metainfo.piece_length
        return blob[start : start + entry.length]
