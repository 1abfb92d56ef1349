"""Training entry point: ``python -m repro_torch.launch.train``
(counterpart of ``repro/launch/train.py``).

The same path as the reference's: the swarm fabric ingests a seeded
corpus onto two hosts, the host batcher cuts it into next-token windows,
and the Trainer runs with periodic checkpoints under the restart
supervisor. The config is always the arch's ``.reduce()``, as the
reference's ``--reduced`` (a flag that defaults to True) makes it; the
full configs are trained through :class:`~repro_torch.train.Trainer`
directly. It runs on the CUDA card, through K4 and its backward K4b (and
K5, K6 for the state archs; the MoE archs add their router losses to the
loss); ``--device cpu`` runs the kernels' plain PyTorch versions on the
host, e.g.::

    python -m repro_torch.launch.train --device cpu --steps 20
    python -m repro_torch.launch.train --arch gemma2_2b --crash-at 12
    python -m repro_torch.launch.train --arch dbrx_132b --device cpu --steps 6

One process, one device, as the reference's driver runs on a CPU
container: the mesh-aware and compressed steps are
``train.make_train_step(..., mesh=, pod_axis=)`` on a mesh of
:mod:`.mesh`, and ``--grad-compression int8`` here keeps the
error-feedback residual in the optimizer state but, as the reference on
one pod, reduces nothing in int8.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from ..compat import resolve_device
from ..configs import ARCH_IDS, get_config
from ..configs.base import TrainConfig
from ..data import CorpusSpec, HostBatcher, ShardedCorpus, loader_from_corpus
from ..models import build_model
from ..train import FailurePlan, Trainer, TrainerConfig, run_with_restarts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite_3_2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="accepted so that the reference's command lines "
                         "parse; the config is always reduced (the full "
                         "configs train through Trainer directly)")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduce()
    bundle = build_model(cfg, dev)

    corpus = ShardedCorpus(CorpusSpec(
        num_shards=8,
        tokens_per_shard=max((args.seq_len + 1) * args.global_batch * 4, 1 << 15),
        vocab_size=cfg.vocab_size,
    ))
    # one process: host 0 of the reference's two-host minimum
    loader = loader_from_corpus(corpus, num_hosts=2)
    report = loader.ingest("full_replica")
    print(f"[launch.train] swarm ingest U/D={report.ud_ratio:.1f} "
          f"rounds={report.rounds}")
    batcher = HostBatcher(
        [loader.host_shard_tokens(0, s) for s in range(8)],
        batch_size=args.global_batch, seq_len=args.seq_len,
    )

    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    trainer = Trainer(
        bundle, tcfg, batcher,
        TrainerConfig(ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 5, 10),
                      log_every=max(args.steps // 20, 5)),
        failure_plan=FailurePlan(crash_at_steps=(args.crash_at,))
        if args.crash_at else None,
    )
    final, restarts = run_with_restarts(
        lambda: trainer.run(args.steps).final_step,
        on_restart=lambda n, e: print(f"[launch.train] restart #{n}: {e}"),
    )
    print(f"[launch.train] done step={final} restarts={restarts} on {dev}")


if __name__ == "__main__":
    main()
