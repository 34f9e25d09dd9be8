"""Learning-rate schedules as plain functions of the global step. Port of
`customstep` from face_recognition_models_tpu/train/schedules.py.

CustomStepLR (reference schedulers.py:3-16) multiplies the lr by `ratio` at
each epoch in `steps`; per step that is a boundary at s * steps_per_epoch,
reached when step >= boundary.
"""

from __future__ import annotations

from typing import Callable, Sequence

from face_recognition_models_tpu_torch.config import ScheduleConfig

Schedule = Callable[[int], float]


def customstep_schedule(lr0: float, steps: Sequence[int], ratio: float,
                        steps_per_epoch: int) -> Schedule:
    boundaries = [s * steps_per_epoch for s in steps]

    def schedule(count: int) -> float:
        return lr0 * ratio ** sum(count >= b for b in boundaries)

    return schedule


def get_schedule(cfg: ScheduleConfig, learning_rate: float,
                 steps_per_epoch: int) -> Schedule:
    if cfg.name != "customstep":
        raise ValueError(f"schedule '{cfg.name}' is not ported yet "
                         "(customstep only)")
    return customstep_schedule(learning_rate, cfg.steps, cfg.ratio,
                               max(1, steps_per_epoch))
