"""Learning-rate schedules: log-linear / log-cosine with warm restarts.

Port of ``primia_tpu/train/lr.py`` (reference ``torchlib/utils.py:37-89``,
``LearningRateScheduler``): a pure function of the epoch, in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class LearningRateScheduler:
    """Interpolates between ``10**log_start_lr`` and ``10**log_end_lr``.

    ``restarts=r`` splits the schedule into ``r+1`` identical cycles
    (the epoch wraps modulo the cycle length).
    """

    def __init__(
        self,
        total_epochs: int,
        log_start_lr: float,
        log_end_lr: float,
        schedule_plan: str = "log_linear",
        restarts: Optional[int] = None,
    ):
        if restarts == 0:
            restarts = None
        self.total_epochs = (
            total_epochs if not restarts else total_epochs / (restarts + 1)
        )
        if schedule_plan == "log_linear":
            self.calc_lr = lambda epoch: np.power(
                10,
                ((log_end_lr - log_start_lr) / self.total_epochs) * epoch
                + log_start_lr,
            )
        elif schedule_plan == "log_cosine":
            self.calc_lr = lambda epoch: np.power(
                10,
                (np.cos(np.pi * (epoch / self.total_epochs)) / 2.0 + 0.5)
                * abs(log_start_lr - log_end_lr)
                + log_end_lr,
            )
        else:
            raise NotImplementedError(
                f"Requested learning rate schedule {schedule_plan} not implemented"
            )

    def get_lr(self, epoch) -> float:
        epoch = epoch % self.total_epochs
        if (isinstance(epoch, (int, float)) and epoch > self.total_epochs) or (
            isinstance(epoch, np.ndarray) and np.max(epoch) > self.total_epochs
        ):
            raise AssertionError("Requested epoch out of precalculated schedule")
        return float(self.calc_lr(epoch))


def make_scheduler(args) -> LearningRateScheduler:
    """Scheduler from an ``Arguments`` (reference ``train.py:193-199``:
    log-linear between lr and end_lr over the epoch count)."""
    return LearningRateScheduler(
        max(args.epochs, 1),
        np.log10(args.lr),
        np.log10(args.end_lr),
        restarts=args.restarts,
    )
