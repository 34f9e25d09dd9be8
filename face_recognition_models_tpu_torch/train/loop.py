"""The epoch loop. Port of `fit` from face_recognition_models_tpu/train/
loop.py, with checkpoints and resume, without mesh, partial-FC, EMA or
distillation yet.

Metrics stay on the device and are read (which waits for the card) only at
`print_freq` steps and at the end of each epoch. Heads that need a second
view of the batch (QAFace) get `degrade_images` of it, made on the device.

With a checkpoint manager, a fresh run wipes its directory and a run with
`cfg.continue_train` resumes from it; each epoch saves the best-by-loss
checkpoint when its loss is a new minimum, then its epoch checkpoint; a
SIGTERM or SIGINT finishes the current step, saves epoch - 1 (resume with
continue_train='latest') and returns.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    # a SIGTERM / SIGINT ended the run after a checkpoint of epoch - 1
    preempted: bool = False


def degrade_images(images: torch.Tensor) -> torch.Tensor:
    """Quality-degraded view for QAFace's `minput`: a 2x down / up bilinear
    resample of NHWC images on their device, antialiased as
    jax.image.resize is.

    Keeps the input dtype: a uint8 batch comes back uint8 (rounded, in
    [0, 255]) so the step normalises both views alike; a float batch stays
    float.
    """
    _, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    small = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                          align_corners=False, antialias=True)
    out = F.interpolate(small, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    if images.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return out


class HostStaging:
    """Copies each loader batch to the device through two reusable pinned
    host buffers, the PyTorch form of the JAX loop's device_put of a
    prefetched batch: a copy from pinned memory runs asynchronously on the
    stream, where one from pageable memory is staged by the driver first.

    A batch is copied into the next buffer, sent with non_blocking=True,
    and a CUDA event is recorded after its copies; a buffer is refilled
    only once its event has completed, so a copy in flight is never
    overwritten. On the CPU a batch goes as it is, with no pinning.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: List[Optional[tuple]] = [None, None]
        self._next = 0

    def __call__(self, images, labels):
        """(images, labels) on the device for one loader batch."""
        if self.device.type != "cuda":
            return torch.as_tensor(images).to(self.device), labels
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels, dtype=torch.int32)
        i, self._next = self._next, (self._next + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[2].synchronize()   # the copy out of this buffer is done
        if (slot is None or slot[0].shape != images.shape
                or slot[0].dtype != images.dtype
                or slot[1].shape != labels.shape):
            slot = (torch.empty(images.shape, dtype=images.dtype,
                                pin_memory=True),
                    torch.empty(labels.shape, dtype=torch.int32,
                                pin_memory=True),
                    torch.cuda.Event())
            self._slots[i] = slot
        host_images, host_labels, done = slot
        host_images.copy_(images)
        host_labels.copy_(labels)
        out = (host_images.to(self.device, non_blocking=True),
               host_labels.to(self.device, non_blocking=True))
        done.record()
        return out


def _install_preemption_handlers(flag: dict) -> dict:
    """Point SIGTERM and SIGINT at a handler that sets flag['set'];
    returns the previous handlers. Off the main thread signal.signal
    raises and nothing is installed."""
    def on_signal(signum, frame):
        flag["set"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            break
    return previous


def fit(cfg: cfg_lib.TrainConfig, loader, device=None,
        head_cfg=None, checkpoint_manager: Optional[Any] = None
        ) -> FitResult:
    """Train for cfg.epochs over `loader` (any object with steps_per_epoch()
    and epoch(i) -> iterator of (uint8 NHWC images, int labels)).

    With `checkpoint_manager` (checkpoint/manager.CheckpointManager) the
    run saves and resumes as the module docstring says; a resumed run
    takes cfg.epochs more epochs from the one after the checkpoint's.
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
    start_epoch = 1
    if checkpoint_manager is not None:
        if cfg.continue_train is None:
            checkpoint_manager.reset()
        else:
            restored, start_epoch, loss = checkpoint_manager.restore(
                state, mode=cfg.continue_train)
            if restored is not None:
                # a non-finite saved loss must not block every later best
                min_train_loss = loss if np.isfinite(loss) else float("inf")
                print(f"### Resuming from epoch {start_epoch - 1} "
                      f"(train_loss={loss:.6f}) ###")

    stage = HostStaging(device)
    preempted = {"set": False}
    previous = (_install_preemption_handlers(preempted)
                if checkpoint_manager is not None else {})
    last_epoch = cfg.epochs + start_epoch - 1
    all_losses, step_seconds = [], []
    total_images = steps_run = 0
    t_start = end = time.perf_counter()
    try:
        for epoch in range(start_epoch, last_epoch + 1):
            losses = []
            for i, (images, labels) in enumerate(loader.epoch(epoch)):
                images, labels = stage(images, labels)
                if head.requires_minput:
                    state, metrics = step_fn(state, images, labels,
                                             degrade_images(images))
                else:
                    state, metrics = step_fn(state, images, labels)
                losses.append(metrics["loss"])
                total_images += len(images)
                steps_run += 1
                if i % cfg.print_freq == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"Epoch: [{epoch}/{last_epoch}][{i + 1}/"
                          f"{steps_per_epoch}] loss {m['loss']:.4f} "
                          f"acc1 {m['acc1']:.2f} acc5 {m['acc5']:.2f} "
                          f"lr {m['lr']:.5f} feat_norm {m['feat_norm']:.3f}",
                          flush=True)
                now = time.perf_counter()
                step_seconds.append(now - end)
                end = now
                if preempted["set"]:
                    break
            epoch_losses = [float(x) for x in losses]
            all_losses += epoch_losses
            train_loss = float(np.mean(epoch_losses))
            if preempted["set"]:
                checkpoint_manager.save(state, epoch - 1, train_loss)
                print(f"### Preemption: saved checkpoint at epoch "
                      f"{epoch - 1} step {len(losses)} — resume with "
                      f"continue_train='latest' ###", flush=True)
                break
            if checkpoint_manager is not None:
                if train_loss < min_train_loss:
                    min_train_loss = train_loss
                    checkpoint_manager.save(state, epoch, train_loss,
                                            is_best=True)
                    print(f"New best model saved: {train_loss:.6f}")
                checkpoint_manager.save(state, epoch, train_loss)
            else:
                min_train_loss = min(min_train_loss, train_loss)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    wall = time.perf_counter() - t_start
    return FitResult(state=state, head_cfg=head_cfg,
                     min_train_loss=min_train_loss, epochs_run=cfg.epochs,
                     steps_per_sec=steps_run / max(wall, 1e-9),
                     images_per_sec=total_images / max(wall, 1e-9),
                     losses=all_losses, step_seconds=step_seconds,
                     preempted=preempted["set"])
