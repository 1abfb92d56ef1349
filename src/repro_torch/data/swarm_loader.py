"""Swarm-backed shard ingestion — the paper's system as a data pipeline.

Every training host runs a peer; the dataset origin (blob store) runs the
seeder. Before/while training, hosts pull their shard assignments through
the swarm (`LocalSwarm`, byte-accurate and verified) instead of each
hammering the origin — cutting origin egress by the U/D factor the paper
measures (Eq. 1) and making cold-start time ~independent of fleet size
(Fig. 1 right panel).

Modes:
  * ``full_replica`` — every host fetches every shard (small corpora;
    maximal sharing; also the checkpoint-bundle path).
  * ``partitioned``  — host *h* fetches only the pieces of shards assigned
    to it this epoch; it still serves everything it holds, so origin
    egress stays ~1 copy total.

Resumability: possession lives in each host's content-addressed
:class:`ShardStore`; a restarted host recomputes its bitfield from disk and
rejoins the swarm needing only what it lost.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.metainfo import MetaInfo
from ..core.swarm import LocalSwarm
from ..core.webseed import OriginPolicy
from .dataset import ShardedCorpus, bytes_to_shard, pieces_for_shard, shard_file_entries
from .shardstore import ShardStore


@dataclasses.dataclass
class IngestReport:
    rounds: int
    origin_uploaded: float
    total_downloaded: float
    per_host_pieces: dict[str, int]
    origin_http_uploaded: float = 0.0   # web-seed range-read share of egress
    pod_cache_uploaded: float = 0.0     # bytes served out of pod-local caches
    cross_pod_bytes: float = 0.0        # transfers whose endpoints straddle pods
    hedge_cancelled_bytes: float = 0.0  # losing hedge duplicates (tail insurance)
    # per-host tail latency in rounds: {"p50", "p95", "p99"} of the round
    # each host satisfied its needed set ({} if nothing completed)
    completion_percentiles: dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def ud_ratio(self) -> float:
        if self.origin_uploaded <= 0:
            return float("inf") if self.total_downloaded else 0.0
        return self.total_downloaded / self.origin_uploaded


def shard_assignment(
    num_shards: int, num_hosts: int, epoch: int, seed: int = 0
) -> list[list[int]]:
    """Deterministic per-epoch shard -> host assignment (rotating shuffle)."""
    rng = np.random.default_rng(seed + 1000003 * epoch)
    order = rng.permutation(num_shards)
    return [sorted(int(s) for s in order[h::num_hosts]) for h in range(num_hosts)]


class SwarmShardLoader:
    """Drives swarm ingestion into per-host stores and exposes host shards."""

    def __init__(
        self,
        manifest: MetaInfo,
        origin_pieces: dict[int, bytes],
        host_stores: Sequence[ShardStore],
        seed: int = 0,
        webseed: Optional[OriginPolicy] = None,
        mirrors: Optional[Sequence] = None,
        pods: Optional[int] = None,
    ):
        """``webseed``: serve the origin as a bare HTTP byte-range server
        (see :mod:`repro_torch.core.webseed`) — cold-start ingest then begins
        from an un-seeded origin: the first copy of each piece enters the
        swarm via a verified range read, after which hosts amplify it.

        ``mirrors``: optional :class:`~repro_torch.core.webseed.MirrorSpec` list
        replicating the origin behind several endpoints (verified failover
        between them). ``pods``: partition the hosts contiguously into this
        many pods, each with a pod-local cache proxy — cold start then
        range-reads from the *nearest cache* instead of the root origin,
        and the report ledgers cache egress and cross-pod bytes."""
        self.manifest = manifest
        self.origin_pieces = origin_pieces
        self.host_stores = list(host_stores)
        self.seed = seed
        self.webseed = webseed
        self.mirrors = list(mirrors) if mirrors is not None else None
        self.host_ids = [f"host{i:04d}" for i in range(len(host_stores))]
        self.pod_of: Optional[dict[str, int]] = None
        if pods is not None:
            if webseed is None:
                raise ValueError("pods (cache tier) requires a webseed policy")
            if pods < 1:
                raise ValueError(f"pods must be >= 1, got {pods}")
            n = len(self.host_ids)
            self.pod_of = {
                hid: (i * pods) // n for i, hid in enumerate(self.host_ids)
            }
        self.last_report: Optional[IngestReport] = None

    # ------------------------------------------------------------- ingestion
    def _needed_masks(
        self, assignment: Optional[list[list[int]]]
    ) -> Optional[dict[str, np.ndarray]]:
        if assignment is None:
            return None
        entries = shard_file_entries(self.manifest)
        masks = {}
        for hid, shards in zip(self.host_ids, assignment):
            mask = np.zeros(self.manifest.num_pieces, dtype=bool)
            for s in shards:
                for p in pieces_for_shard(self.manifest, entries[s]):
                    mask[p] = True
            masks[hid] = mask
        return masks

    def ingest(
        self,
        mode: str = "full_replica",
        epoch: int = 0,
        policy: str = "rarest_first",
    ) -> IngestReport:
        assignment = None
        if mode == "partitioned":
            assignment = shard_assignment(
                len(shard_file_entries(self.manifest)),
                len(self.host_stores),
                epoch,
                self.seed,
            )
        elif mode != "full_replica":
            raise ValueError(f"unknown ingest mode {mode!r}")

        swarm = LocalSwarm(
            self.manifest,
            self.origin_pieces,
            self.host_ids,
            seed=self.seed + epoch,
            policy=policy,
            needed=self._needed_masks(assignment),
            webseed=self.webseed,
            mirrors=self.mirrors,
            pod_of=self.pod_of,
            pod_caches=self.pod_of is not None,
        )
        # resumability: pre-seed swarm bitfields from what stores already hold
        for hid, store in zip(self.host_ids, self.host_stores):
            agent = swarm.peers[hid]
            held = store.pieces(self.manifest)
            for idx, data in held.items():
                agent.store[idx] = data
                if not agent.bitfield.has(idx):
                    agent.bitfield.set(idx)
            for other_id, other in {**swarm.peers, "origin": swarm.origin}.items():
                if other_id != hid:
                    for idx in held:
                        other.on_have(hid, idx)
        rounds = swarm.run()
        # write-through: verified pieces -> content-addressed stores
        for hid, store in zip(self.host_ids, self.host_stores):
            for idx, data in swarm.peers[hid].store.items():
                store.put_piece(self.manifest, idx, data)
        ledgers = swarm.ledgers()
        self.last_report = IngestReport(
            rounds=rounds,
            origin_uploaded=ledgers["origin"].uploaded,
            total_downloaded=sum(
                l.downloaded for pid, l in ledgers.items() if pid != "origin"
            ),
            per_host_pieces={
                hid: swarm.peers[hid].bitfield.count() for hid in self.host_ids
            },
            origin_http_uploaded=swarm.http_uploaded,
            pod_cache_uploaded=swarm.pod_cache_uploaded,
            cross_pod_bytes=swarm.cross_pod_bytes,
            hedge_cancelled_bytes=swarm.hedge_cancelled_bytes,
            completion_percentiles=(
                swarm.completion_percentiles() if swarm.peers else {}
            ),
        )
        return self.last_report

    # ------------------------------------------------------------- consumption
    def host_shard_tokens(self, host: int, shard_index: int) -> np.ndarray:
        entries = shard_file_entries(self.manifest)
        blob = self.host_stores[host].extract_file(
            self.manifest, entries[shard_index].name
        )
        if blob is None:
            raise KeyError(
                f"host {host} is missing pieces of shard {shard_index} "
                "(ingest it first)"
            )
        return bytes_to_shard(blob)


    def ingest_streaming(
        self,
        window: int = 2,
        epoch: int = 0,
    ):
        """Windowed streaming ingest: yield shard indices as they complete.

        Shards are fetched in **sequential piece order** with a lookahead of
        ``window`` shards, so training can consume shard *i* while the swarm
        is still pulling shards [i+1, i+window) — the fabric-level analogue
        of `pipeline.prefetch`. Every host streams the full shard sequence
        (full-replica semantics); pieces already cached are skipped, so a
        restarted host fast-forwards through what it holds.
        """
        entries = shard_file_entries(self.manifest)
        n = len(entries)
        swarm = LocalSwarm(
            self.manifest, self.origin_pieces, self.host_ids,
            seed=self.seed + 7919 * epoch, policy="sequential",
            webseed=self.webseed,
            mirrors=self.mirrors,
            pod_of=self.pod_of,
            pod_caches=self.pod_of is not None,
        )
        for hid, store in zip(self.host_ids, self.host_stores):
            agent = swarm.peers[hid]
            for idx, data in store.pieces(self.manifest).items():
                agent.store[idx] = data
                if not agent.bitfield.has(idx):
                    agent.bitfield.set(idx)

        def shard_done(shard: int) -> bool:
            need = pieces_for_shard(self.manifest, entries[shard])
            return all(
                all(a.bitfield.has(p) for p in need)
                for a in swarm.peers.values()
            )

        emitted = 0
        guard = 0
        idle = 0
        while emitted < n:
            target = min(emitted + window, n)
            # run swarm rounds until the current window's shards are complete
            while not all(shard_done(s) for s in range(emitted, target)):
                idle = idle + 1 if swarm.step() == 0 else 0
                if idle > swarm.MAX_IDLE_ROUNDS and not swarm.complete:
                    raise RuntimeError("streaming ingest stalled")
                guard += 1
                if guard > 100_000:
                    raise RuntimeError("streaming ingest did not converge")
            while emitted < target and shard_done(emitted):
                for hid, store in zip(self.host_ids, self.host_stores):
                    agent = swarm.peers[hid]
                    for p in pieces_for_shard(self.manifest, entries[emitted]):
                        if p in agent.store:
                            store.put_piece(self.manifest, p, agent.store[p])
                yield emitted
                emitted += 1
        ledgers = swarm.ledgers()
        self.last_report = IngestReport(
            rounds=swarm.rounds,
            origin_uploaded=ledgers["origin"].uploaded,
            total_downloaded=sum(
                l.downloaded for pid, l in ledgers.items() if pid != "origin"
            ),
            per_host_pieces={
                hid: swarm.peers[hid].bitfield.count() for hid in self.host_ids
            },
            origin_http_uploaded=swarm.http_uploaded,
            pod_cache_uploaded=swarm.pod_cache_uploaded,
            cross_pod_bytes=swarm.cross_pod_bytes,
            hedge_cancelled_bytes=swarm.hedge_cancelled_bytes,
            completion_percentiles=(
                swarm.completion_percentiles() if swarm.peers else {}
            ),
        )


def loader_from_corpus(
    corpus: ShardedCorpus, num_hosts: int, seed: int = 0,
    directories: Optional[Sequence[str]] = None,
    webseed: Optional[OriginPolicy] = None,
    mirrors: Optional[Sequence] = None,
    pods: Optional[int] = None,
) -> SwarmShardLoader:
    stores = [
        ShardStore(directories[i] if directories else None)
        for i in range(num_hosts)
    ]
    return SwarmShardLoader(
        corpus.manifest, corpus.origin_pieces(), stores, seed=seed,
        webseed=webseed, mirrors=mirrors, pods=pods,
    )
