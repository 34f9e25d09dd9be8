"""The epoch loop. Port of `fit` from face_recognition_models_tpu/train/
loop.py, without mesh, partial-FC, EMA, distillation or checkpoints yet.

Metrics stay on the device and are read (which waits for the card) only at
`print_freq` steps and at the end of each epoch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.train.schedules import get_schedule
from face_recognition_models_tpu_torch.train.state import create_train_state
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.device import resolve_device


@dataclass
class FitResult:
    state: Any
    head_cfg: Any
    min_train_loss: float
    epochs_run: int
    steps_per_sec: float
    images_per_sec: float
    # per-step loss, and host seconds from the end of one step to the end of
    # the next (they include the wait for the card only at print_freq steps)
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)


def fit(cfg: cfg_lib.TrainConfig, loader, device=None,
        head_cfg=None) -> FitResult:
    """Train for cfg.epochs over `loader` (any object with steps_per_epoch()
    and epoch(i) -> iterator of (uint8 NHWC images, int labels)).

    Runs on the card unless device='cpu' is passed; raises without one.
    """
    device = resolve_device(device)
    if head_cfg is None:
        head_cfg = cfg_lib.make_head_config(cfg.head,
                                            num_classes=cfg.num_classes)
    steps_per_epoch = loader.steps_per_epoch()
    if steps_per_epoch <= 0:
        raise ValueError("loader yields no full batches")
    schedule = get_schedule(cfg.schedule, cfg.optimizer.learning_rate,
                            steps_per_epoch)
    _, head, state = create_train_state(cfg, head_cfg, device)
    step_fn = make_train_step(head, head_cfg, lr_schedule=schedule,
                              mean=cfg.data.mean, std=cfg.data.std,
                              use_fused_head=cfg.use_fused_head,
                              device=device)

    min_train_loss = float("inf")
    all_losses, step_seconds = [], []
    total_images = 0
    t_start = end = time.perf_counter()
    for epoch in range(1, cfg.epochs + 1):
        losses = []
        for i, (images, labels) in enumerate(loader.epoch(epoch)):
            state, metrics = step_fn(state, images, labels)
            losses.append(metrics["loss"])
            total_images += len(images)
            if i % cfg.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"Epoch: [{epoch}/{cfg.epochs}][{i + 1}/"
                      f"{steps_per_epoch}] loss {m['loss']:.4f} "
                      f"acc1 {m['acc1']:.2f} acc5 {m['acc5']:.2f} "
                      f"lr {m['lr']:.5f} feat_norm {m['feat_norm']:.3f}",
                      flush=True)
            now = time.perf_counter()
            step_seconds.append(now - end)
            end = now
        epoch_losses = [float(x) for x in losses]
        all_losses += epoch_losses
        min_train_loss = min(min_train_loss, float(np.mean(epoch_losses)))
    wall = time.perf_counter() - t_start
    return FitResult(state=state, head_cfg=head_cfg,
                     min_train_loss=min_train_loss, epochs_run=cfg.epochs,
                     steps_per_sec=state.step / max(wall, 1e-9),
                     images_per_sec=total_images / max(wall, 1e-9),
                     losses=all_losses, step_seconds=step_seconds)
