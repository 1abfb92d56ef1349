"""Training loop: step -> metrics -> periodic checkpoint -> resume
(counterpart of ``repro/train/trainer.py``).

The loop composes the pieces: the data pipeline (:mod:`repro_torch.data`),
the train step, checkpoint/restart (:mod:`.checkpoint`), failure injection
and the straggler watch (:mod:`.fault_tolerance`). On preemption it
checkpoints inside the grace period; on a crash the supervisor restarts it
and it resumes from the latest durable step, replaying nothing: the
restored parameters, moments and data cursor give the same remaining
updates, so a crashed and restarted run ends with the parameters of an
uninterrupted one.

The reference's ``jax.random`` key becomes a ``torch.Generator`` on the
bundle's device (seeded with ``TrainConfig.seed`` unless one is given);
its ``jax.jit(..., donate_argnums)`` has no counterpart, the step updating
the state in place. A step's time is the host's clock around it, as the
reference's.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

from ..configs.base import TrainConfig
from ..data.pipeline import Batch, DataState, HostBatcher
from ..models.model import ModelBundle
from . import checkpoint as ckpt
from .fault_tolerance import FailurePlan, Preemption, StragglerDetector
from .train_step import (
    TrainState, init_train_state, make_train_step, shard_train_state,
)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    keep_last: int = 3


@dataclasses.dataclass
class TrainReport:
    final_step: int
    losses: list[float]
    restarts: int = 0
    stragglers: int = 0


class Trainer:
    def __init__(
        self,
        bundle: ModelBundle,
        tcfg: TrainConfig,
        batcher: HostBatcher,
        trainer_cfg: TrainerConfig = TrainerConfig(),
        mesh=None,
        pod_axis: Optional[str] = None,
        failure_plan: Optional[FailurePlan] = None,
        log_fn: Callable[[str], None] = print,
    ):
        self.bundle = bundle
        self.tcfg = tcfg
        self.batcher = batcher
        self.cfg = trainer_cfg
        self.failure_plan = failure_plan or FailurePlan()
        self.straggler = StragglerDetector()
        self.log = log_fn
        self.mesh = mesh
        self.train_step = make_train_step(bundle, tcfg, mesh=mesh,
                                          pod_axis=pod_axis)

    # ------------------------------------------------------------- state io
    def _save(self, state: TrainState, step: int) -> None:
        ckpt.save_checkpoint(
            self.cfg.ckpt_dir, step,
            {"params": state.params, "opt": state.opt},
            extra={"data": self.batcher.state.to_dict(), "step": step},
        )
        self._gc_checkpoints()

    def _gc_checkpoints(self) -> None:
        base = Path(self.cfg.ckpt_dir)
        steps = sorted(
            int(p.name.split("_")[1])
            for p in base.iterdir()
            if p.is_dir() and p.name.startswith("step_")
        )
        for s in steps[: -self.cfg.keep_last]:
            shutil.rmtree(base / f"step_{s:08d}")

    def _restore_or_init(self, generator: torch.Generator
                         ) -> tuple[TrainState, int]:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        state = init_train_state(self.bundle, self.tcfg, generator)
        step = 0
        if last is not None:
            _, extra = ckpt.load_checkpoint(
                self.cfg.ckpt_dir, {"params": state.params,
                                    "opt": state.opt}, step=last)
            self.batcher.state = DataState.from_dict(extra["data"])
            self.log(f"[trainer] resumed from step {last}")
            step = last
        if self.mesh is not None:       # the mesh step's layout
            state = shard_train_state(state, self.bundle, self.mesh)
        return state, step

    # ------------------------------------------------------------- loop
    def run(self, num_steps: int,
            generator: Optional[torch.Generator] = None) -> TrainReport:
        if generator is None:
            generator = torch.Generator(device=self.bundle.device)
            generator.manual_seed(self.tcfg.seed)
        state, start = self._restore_or_init(generator)
        losses: list[float] = []
        it: Iterator[Batch] = self.batcher.iter_from(self.batcher.state)
        step = start
        while step < num_steps:
            batch = next(it)
            t0 = time.perf_counter()
            try:
                self.failure_plan.check(step)
            except Preemption:
                # grace period: persist, then let the supervisor reschedule
                self._save(state, step)
                raise
            state, metrics = self.train_step(
                state, {"tokens": torch.from_numpy(batch.tokens),
                        "targets": torch.from_numpy(batch.targets)}
            )
            step += 1
            dt = time.perf_counter() - t0
            if self.straggler.observe(dt):
                self.log(f"[trainer] straggler step {step}: {dt:.3f}s")
            if step % self.cfg.log_every == 0 or step == num_steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                self.log(
                    f"[trainer] step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                )
            if step % self.cfg.ckpt_every == 0 or step == num_steps:
                self._save(state, step)
        return TrainReport(
            final_step=step, losses=losses, stragglers=self.straggler.flagged
        )
