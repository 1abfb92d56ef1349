"""repro_torch.train — optimizer, train step, checkpointing, fault
tolerance (counterpart of ``repro.train``, with its names)."""

from .checkpoint import (
    checkpoint_metainfo, latest_step, load_checkpoint, restore_from_bundle,
    save_checkpoint,
)
from .fault_tolerance import (
    FailurePlan, Preemption, SimulatedFailure, StragglerDetector, run_with_restarts,
)
from .optimizer import OptState, adamw_init, adamw_update, global_norm, lr_schedule
from .train_step import TrainState, init_train_state, make_eval_step, make_train_step
from .trainer import Trainer, TrainerConfig, TrainReport

__all__ = [k for k in dir() if not k.startswith("_")]
