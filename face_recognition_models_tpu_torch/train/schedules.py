"""Learning-rate schedules as functions of the step count on the device.
Port of face_recognition_models_tpu/train/schedules.py: step, multistep,
customstep, cosine, exponential, warmup_cosine and none.

The reference steps its schedulers once per epoch; here every schedule is a
function of the global step count, converted through `steps_per_epoch`, as
in the JAX package. A schedule takes the count as a 0-d integer tensor on
the train state's device and returns the lr as a 0-d float32 tensor there,
computed in float32 the way the traced JAX function computes it: epoch =
count // steps_per_epoch, `ratio ** n` with n the boundaries reached. It
reads nothing back to the host, so a CUDA graph of train steps holds it and
each replay computes the lr of its own count.

CustomStepLR parity (reference schedulers.py:3-16): 1-based epoch e trains
with lr0 * ratio^|{s in steps : s <= e - 1}|, a boundary at each s in
0-based epochs (= count // steps_per_epoch).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from face_recognition_models_tpu_torch.config import ScheduleConfig

Schedule = Callable[[torch.Tensor], torch.Tensor]

SCHEDULES = ("step", "multistep", "customstep", "cosine", "exponential",
             "warmup_cosine", "none")

# Numeric ids match the reference's active entries only (schedulers.py:17-31),
# so integer configs ported from the reference select the same schedule; the
# extra schedules (exponential, warmup_cosine) go by name only.
SCHEDULER_DICT = {1: "step", 2: "multistep", 3: "customstep", 4: "cosine",
                  5: "none"}


def _epoch_of(count: torch.Tensor, steps_per_epoch: int) -> torch.Tensor:
    return count.to(torch.float32) // steps_per_epoch


def _boundary_schedule(lr0: float, epochs: Sequence[int], ratio: float,
                       steps_per_epoch: int, device) -> Schedule:
    """lr0 * ratio^n, n the boundaries (epoch * steps_per_epoch) that the
    count has reached."""
    boundaries = torch.tensor([e * steps_per_epoch for e in epochs],
                              dtype=torch.int64, device=device)

    def schedule(count):
        n = (count >= boundaries).sum()
        return lr0 * ratio ** n.to(torch.float32)

    return schedule


def get_schedule(cfg: ScheduleConfig, learning_rate: float,
                 steps_per_epoch: int, num_epochs: int = None,
                 device=None) -> Schedule:
    """The schedule `cfg.name` names (or its numeric id) for a run of
    `num_epochs` epochs of `steps_per_epoch` steps; its constants live on
    `device` (the CPU by default)."""
    if isinstance(cfg.name, int):
        if cfg.name not in SCHEDULER_DICT:
            raise ValueError(
                f"Invalid scheduler id: {cfg.name}. Numeric ids follow the "
                f"reference table {SCHEDULER_DICT}; use names for the rest.")
        name = SCHEDULER_DICT[cfg.name]
    else:
        name = cfg.name.lower()
    lr0 = learning_rate
    spe = max(1, steps_per_epoch)

    if name == "none":
        lr = torch.full((), lr0, dtype=torch.float32, device=device)
        return lambda count: lr

    if name == "customstep":
        return _boundary_schedule(lr0, cfg.steps, cfg.ratio, spe, device)

    if name == "step":
        def schedule(count):
            e = _epoch_of(count, spe)
            return lr0 * cfg.gamma ** torch.floor(e / cfg.step_size)
        return schedule

    if name == "multistep":
        return _boundary_schedule(lr0, cfg.milestones, cfg.gamma, spe, device)

    if name == "cosine":
        if num_epochs is None:
            raise ValueError("num_epochs must be provided for cosine schedule")

        def schedule(count):
            e = _epoch_of(count, spe)
            return cfg.eta_min + (lr0 - cfg.eta_min) * 0.5 * (
                1.0 + torch.cos(math.pi * e / num_epochs))
        return schedule

    if name == "exponential":
        def schedule(count):
            e = _epoch_of(count, spe)
            return lr0 * cfg.gamma ** e
        return schedule

    if name == "warmup_cosine":
        if num_epochs is None:
            raise ValueError("num_epochs must be provided for warmup_cosine")
        warm = cfg.warmup_epochs

        def schedule(count):
            e = _epoch_of(count, spe)
            warm_lr = lr0 * e / warm
            cos_lr = lr0 * 0.5 * (
                1.0 + torch.cos(math.pi * (e - warm) / (num_epochs - warm)))
            return torch.where(e < warm, warm_lr, cos_lr)
        return schedule

    raise ValueError(f"Unknown scheduler name: {name}. Available: {SCHEDULES}")
