"""repro_torch.data — swarm-backed dataset substrate (see DESIGN.md §3)."""

from .dataset import (
    CorpusSpec,
    ShardedCorpus,
    bytes_to_shard,
    generate_shard,
    pieces_for_shard,
    shard_file_entries,
    shard_to_bytes,
)
from .pipeline import Batch, DataState, HostBatcher, global_batch_layout, prefetch
from .shardstore import ShardStore
from .swarm_loader import IngestReport, SwarmShardLoader, loader_from_corpus, shard_assignment
from .tokenizer import ByteTokenizer

__all__ = [k for k in dir() if not k.startswith("_")]
