"""End-to-end training run: swarm-ingested data -> multi-step LM training
with checkpoint/restart. The port of ``examples/train_lm.py``: on the CUDA
card (K4 for the attention and K4b for its backward; K5, K6 for the state
archs) unless ``--device cpu`` asks for the kernels' plain PyTorch versions
on the host.

Presets:
  smoke       ~1M params, 100 steps  (CI / seconds)
  cpu-small   ~10M params, 200 steps (a few minutes on a CPU host)
  paper-100m  ~100M params, 300 steps (the reference run, sized for an
              accelerator)

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset cpu-small \\
          --arch granite_3_2b --steps 200
      PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
          --steps 20 --inject-crash-at 10
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
from torch.utils._pytree import tree_leaves

from ..compat import resolve_device
from ..configs import ARCH_IDS, get_config
from ..configs.base import TrainConfig
from ..data import CorpusSpec, HostBatcher, ShardedCorpus, loader_from_corpus
from ..models import build_model
from ..train import FailurePlan, Trainer, TrainerConfig, run_with_restarts

PRESETS = {
    "smoke": dict(d_model=64, num_heads=4, head_dim=16, d_ff=128,
                  layers_mult=1, vocab=512, batch=8, seq=64, steps=100),
    "cpu-small": dict(d_model=256, num_heads=8, head_dim=32, d_ff=1024,
                      layers_mult=2, vocab=2048, batch=8, seq=128, steps=200),
    "paper-100m": dict(d_model=768, num_heads=12, head_dim=64, d_ff=3072,
                       layers_mult=4, vocab=8192, batch=16, seq=256, steps=300),
}


def main(argv=None) -> dict:
    """Train; returns ``final_step``, ``restarts``, ``params``, the logged
    ``losses`` of the run that finished, ``seconds`` (the supervised run's
    wall, restarts and checkpoints included) and ``device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_3_2b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true",
                    help="keep existing checkpoints and resume")
    ap.add_argument("--inject-crash-at", type=int, default=None,
                    help="simulate a node failure at this step (demo of "
                    "checkpoint/restart)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = PRESETS[args.preset]
    base = get_config(args.arch)
    cfg = base.reduce(
        d_model=p["d_model"], num_heads=p["num_heads"], head_dim=p["head_dim"],
        d_ff=p["d_ff"], vocab_size=p["vocab"],
        num_layers=len(base.block_pattern) * p["layers_mult"]
        + len(base.tail_pattern),
    )
    bundle = build_model(cfg, dev)
    n_params = sum(int(np.prod(t.shape)) for t in tree_leaves(bundle.abstract()))
    steps = args.steps or p["steps"]
    print(f"arch={args.arch} preset={args.preset} params={n_params/1e6:.1f}M "
          f"steps={steps}")

    corpus = ShardedCorpus(CorpusSpec(
        num_shards=8, tokens_per_shard=max((p["seq"] + 1) * p["batch"] * 8, 1 << 15),
        vocab_size=p["vocab"],
    ))
    loader = loader_from_corpus(corpus, num_hosts=2, seed=0)
    rep = loader.ingest("full_replica")
    print(f"swarm ingest: U/D={rep.ud_ratio:.1f} rounds={rep.rounds}")
    shards = [loader.host_shard_tokens(0, s) for s in range(8)]
    batcher = HostBatcher(shards, batch_size=p["batch"], seq_len=p["seq"])

    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    plan = FailurePlan(crash_at_steps=(args.inject_crash_at,)) \
        if args.inject_crash_at else None
    trainer = Trainer(
        bundle,
        TrainConfig(learning_rate=1e-3, warmup_steps=max(steps // 20, 5),
                    total_steps=steps),
        batcher,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=max(steps // 5, 10),
                      log_every=max(steps // 20, 5)),
        failure_plan=plan,
    )
    reports = []

    def run() -> int:
        reports.append(trainer.run(steps))
        return reports[-1].final_step

    t0 = time.perf_counter()
    final, restarts = run_with_restarts(
        run, max_restarts=3,
        on_restart=lambda n, e: print(f"[supervisor] restart #{n} after {e}"),
    )
    seconds = time.perf_counter() - t0
    print(f"done: step={final} restarts={restarts}")
    return dict(final_step=final, restarts=restarts, params=n_params,
                losses=reports[-1].losses, seconds=seconds, device=str(dev))


if __name__ == "__main__":
    main()
