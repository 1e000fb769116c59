"""Training: losses, optimizers and schedules, metrics and the trainer."""

from .losses import get_loss, loss_reduction
from .metrics import MetricAccumulator
from .optimizers import build_optimizer, build_schedule
from .trainer import Trainer, TrainState, restore_checkpoint, save_checkpoint, warm_start

__all__ = [
    "get_loss",
    "loss_reduction",
    "MetricAccumulator",
    "build_optimizer",
    "build_schedule",
    "Trainer",
    "TrainState",
    "restore_checkpoint",
    "save_checkpoint",
    "warm_start",
]
