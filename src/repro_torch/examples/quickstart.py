"""Quickstart: declare a delivery scenario, swarm a dataset, train on it.
The port of ``examples/quickstart.py``, stage for stage.

The 60-second tour of the whole system, through the declarative API:
  1. build a synthetic sharded corpus; its manifest IS a torrent;
  2. *declare* the delivery deployment as a ScenarioSpec — one JSON-able
     value holding content, mirror fabric, policy, arrivals, and a fault
     timeline — and compile it to the time-domain engine (watch origin
     egress collapse to ~1 copy while a mirror dies mid-download);
  3. distribute the corpus to 4 "hosts" through the verified byte-level
     swarm and train a small LM on the swarm-ingested tokens (on the card
     its attention runs through K4 and its backward K4b);
  4. checkpoint it, and broadcast the checkpoint bundle through the swarm.

Run on the CUDA card::

    PYTHONPATH=src python -m repro_torch.examples.quickstart

or on the host (the kernels' plain PyTorch versions)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from ..compat import resolve_device
from ..configs import get_config
from ..configs.base import TrainConfig
from ..core import (
    ArrivalSpec, ContentSpec, EventSpec, FabricSpec, LocalSwarm,
    ManifestSpec, MirrorSpec, OriginPolicy, ScenarioSpec,
)
from ..data import CorpusSpec, HostBatcher, ShardedCorpus, loader_from_corpus
from ..models import build_model
from ..train import Trainer, TrainerConfig, checkpoint_metainfo

STEPS = 60


def main(argv=None):
    """The four stages; returns stage 3's ``TrainReport``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== 1. publish a dataset (manifest == torrent) ===")
    spec = CorpusSpec(num_shards=8, tokens_per_shard=1 << 14,
                      piece_length=1 << 14, vocab_size=512)
    corpus = ShardedCorpus(spec)
    print(f"corpus: {spec.total_tokens} tokens in {spec.num_shards} shards, "
          f"{corpus.manifest.num_pieces} pieces, "
          f"infohash {corpus.manifest.info_hash_hex[:16]}…")

    print("\n=== 2. declare the delivery scenario (one serializable value) ===")
    scenario = ScenarioSpec(
        name="quickstart",
        content=ContentSpec(manifests=(
            ManifestSpec("release", size_bytes=int(256e6),
                         piece_length=int(8e6)),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("mirror-a", up_bps=12e6, weight=2.0),
            MirrorSpec("mirror-b", up_bps=8e6, weight=1.0),
        )),
        arrivals=(ArrivalSpec(kind="flash", n=12, up_bps=25e6,
                              down_bps=50e6),),
        policy=OriginPolicy(swarm_fraction=1.0, origin_up_bps=20e6,
                            selection="least_loaded"),
        events=(EventSpec(kind="mirror_fail", at=30.0, target="mirror-a"),),
        seed=0,
    )
    blob = scenario.to_json()
    print(f"scenario JSON: {len(blob)} bytes; round-trips: "
          f"{ScenarioSpec.from_json(blob) == scenario}")
    result = scenario.build("time").run()
    out = result.outcomes["release"]
    print(f"flash crowd of {out.clients}: {out.completed} completed in "
          f"{out.duration:.0f}s despite mirror-a dying at t=30s; "
          f"origin served {out.origin_uploaded / 256e6:.2f} copies "
          f"(U/D {out.ud_ratio:.1f}x, Eq. 1)")

    print("\n=== 3. swarm the corpus to 4 hosts, train a small LM ===")
    loader = loader_from_corpus(corpus, num_hosts=4, seed=0)
    rep = loader.ingest("full_replica")
    print(f"origin uploaded {rep.origin_uploaded/1e6:.1f} MB for "
          f"{rep.total_downloaded/1e6:.1f} MB delivered "
          f"(U/D amplification {rep.ud_ratio:.1f}x)")
    cfg = get_config("granite_3_2b").reduce(vocab_size=512)
    bundle = build_model(cfg, dev)
    shards = [loader.host_shard_tokens(0, s) for s in range(spec.num_shards)]
    batcher = HostBatcher(shards, batch_size=8, seq_len=64)
    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            "repro_torch_quickstart_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer = Trainer(bundle, TrainConfig(learning_rate=3e-3, warmup_steps=5,
                                          total_steps=STEPS),
                      batcher, TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=30,
                                             log_every=15))
    report = trainer.run(STEPS)
    print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"(on {dev})")

    print("\n=== 4. broadcast the checkpoint through the swarm ===")
    mi, payload = checkpoint_metainfo(ckpt_dir, STEPS, piece_length=1 << 16)
    swarm = LocalSwarm(mi, dict(mi.split_pieces(payload)),
                       [f"host{i}" for i in range(4)], seed=0)
    rounds = swarm.run()
    print(f"checkpoint {mi.length/1e6:.1f} MB replicated to 4 hosts in "
          f"{rounds} rounds; origin served "
          f"{swarm.origin.ledger.uploaded/1e6:.1f} MB "
          f"(U/D {swarm.ud_ratio:.1f}x)")
    print("\nall four stages OK")
    return report


if __name__ == "__main__":
    main()
