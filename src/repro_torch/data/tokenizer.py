"""Byte-level tokenizer for the synthetic corpus.

Vocabulary: 256 raw bytes + BOS/EOS/PAD. Real runs would swap in a
SentencePiece model; the pipeline only depends on `encode/decode/vocab_size`.
"""

from __future__ import annotations

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258


class ByteTokenizer:
    vocab_size = 259
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
        body = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)
        parts = []
        if add_bos:
            parts.append(np.array([BOS_ID], dtype=np.int32))
        parts.append(body)
        if add_eos:
            parts.append(np.array([EOS_ID], dtype=np.int32))
        return np.concatenate(parts)

    def decode(self, ids: np.ndarray) -> str:
        ids = np.asarray(ids)
        body = ids[(ids >= 0) & (ids < 256)].astype(np.uint8)
        return body.tobytes().decode("utf-8", errors="replace")
