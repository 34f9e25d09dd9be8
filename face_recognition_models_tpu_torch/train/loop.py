"""The epoch loop. Port of `fit` from face_recognition_models_tpu/train/
loop.py, with checkpoints and resume, without mesh, partial-FC, EMA or
distillation yet.

Metrics stay on the device and are read (which waits for the card) only at
`print_freq` steps and at the end of each epoch. Heads that need a second
view of the batch (QAFace) get `degrade_images` of it, made on the device.

With `cfg.scan_steps` = K > 1 the loop gathers K loader batches and trains
them as one chunk (train/graphed.py): one replay of a CUDA graph of K steps
on the card, the same K steps in a plain loop on the CPU. Batches of an
epoch that do not fill a chunk run one at a time through the same step.
Metrics come back as [K] vectors, preemption is checked once per chunk, and
a chunk prints when it crosses a `print_freq` step.

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

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.ops.image_ops import degrade_images
from face_recognition_models_tpu_torch.train.graphed import (
    ChunkRunner,
    make_chunk_fn,
)
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
    # scan_steps > 1 on the card: the graph's warm-up + capture seconds, its
    # replays, and the fused-head kernel launches of one replay
    capture_seconds: float = 0.0
    replays: int = 0
    replay_launches: dict = field(default_factory=dict)


class HostStaging:
    """Copies each loader batch to the device through two reusable pinned
    host buffers, the PyTorch form of the JAX loop's device_put of a
    prefetched batch: a copy from pinned memory runs asynchronously on the
    stream, where one from pageable memory is staged by the driver first.

    A batch is copied into the next buffer, sent with non_blocking=True,
    and a CUDA event is recorded after its copies; a buffer is refilled
    only once its event has completed, so a copy in flight is never
    overwritten. Every buffer is pinned at the first batch. On the CPU a
    batch goes as it is, with no pinning. `buffers` sets how many batches
    can be in flight (two: one copying while the next is filled; a chunk of
    K steps stages 2 K, so a chunk is filled while the one before it
    trains). With `out`, the batch is copied into those device tensors (a
    chunk's static slots) instead of new ones.
    """

    def __init__(self, device: torch.device, buffers: int = 2):
        self.device = device
        self._slots: List[Optional[tuple]] = [None] * buffers
        self._next = 0

    def __call__(self, images, labels, out=None):
        """(images, labels) on the device for one loader batch; with `out`,
        a pair of device tensors of the batch's shapes (uint8 and int32),
        copied into those."""
        if self.device.type != "cuda":
            images = torch.as_tensor(images).to(self.device)
            if out is None:
                return images, labels
            out[0].copy_(images)
            out[1].copy_(torch.as_tensor(labels))
            return out
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels, dtype=torch.int32)
        i, self._next = self._next, (self._next + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[2].synchronize()   # the copy out of this buffer is done
        if slot is None:
            # every buffer at the first batch: pinning memory is slow and
            # stalls the card, so it stays out of the later steps
            self._slots = [s or self._buffer(images, labels)
                           for s in self._slots]
            slot = self._slots[i]
        elif (slot[0].shape != images.shape or slot[0].dtype != images.dtype
              or slot[1].shape != labels.shape):
            slot = self._slots[i] = self._buffer(images, labels)
        host_images, host_labels, done = slot
        host_images.copy_(images)
        host_labels.copy_(labels)
        if out is None:
            out = (host_images.to(self.device, non_blocking=True),
                   host_labels.to(self.device, non_blocking=True))
        else:
            out[0].copy_(host_images, non_blocking=True)
            out[1].copy_(host_labels, non_blocking=True)
        done.record()
        return out

    @staticmethod
    def _buffer(images, labels):
        return (torch.empty(images.shape, dtype=images.dtype,
                            pin_memory=True),
                torch.empty(labels.shape, dtype=torch.int32, pin_memory=True),
                torch.cuda.Event())


def _chunks(batches, k: int):
    """The epoch's batches as lists of k, then the ones that do not fill a
    list of k, one a list (the JAX loop's leftovers)."""
    pending = []
    for batch in batches:
        pending.append(batch)
        if len(pending) == k:
            yield pending
            pending = []
    for batch in pending:
        yield [batch]


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
    scan_k = max(1, int(cfg.scan_steps))
    schedule = get_schedule(cfg.schedule, cfg.optimizer.learning_rate,
                            steps_per_epoch, cfg.epochs, device=device)
    _, head, state = create_train_state(cfg, head_cfg, device)
    step_fn = make_train_step(head, head_cfg, lr_schedule=schedule,
                              mean=cfg.data.mean, std=cfg.data.std,
                              use_fused_head=cfg.use_fused_head,
                              lambda_g=cfg.lambda_g, device=device)
    runner = (ChunkRunner(make_chunk_fn(step_fn, head.requires_minput),
                          scan_k, device) if scan_k > 1 else None)

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

    stage = HostStaging(device, buffers=2 * scan_k)
    preempted = {"set": False}
    previous = (_install_preemption_handlers(preempted)
                if checkpoint_manager is not None else {})
    last_epoch = cfg.epochs + start_epoch - 1
    all_losses, step_seconds = [], []
    total_images = steps_run = 0
    t_start = end = time.perf_counter()

    def run_single(images, labels):
        nonlocal state
        images, labels = stage(images, labels)
        if head.requires_minput:
            state, metrics = step_fn(state, images, labels,
                                     degrade_images(images))
        else:
            state, metrics = step_fn(state, images, labels)
        return metrics

    def run_chunk(batches):
        runner.fill(stage, batches)
        return runner.run(state)

    try:
        for epoch in range(start_epoch, last_epoch + 1):
            losses = []   # per-step 0-d tensors and [K] chunk vectors
            i = 0         # steps done this epoch
            for work in _chunks(loader.epoch(epoch), scan_k):
                n = len(work)
                metrics = (run_chunk(work) if runner is not None
                           and n == scan_k else run_single(*work[0]))
                losses.append(metrics["loss"])
                first, i = i, i + n
                total_images += sum(len(b[0]) for b in work)
                steps_run += n
                if first % cfg.print_freq < n:
                    m = {k: float(v.reshape(-1)[-1])
                         for k, v in metrics.items()}
                    print(f"Epoch: [{epoch}/{last_epoch}][{i}/"
                          f"{steps_per_epoch}] loss {m['loss']:.4f} "
                          f"acc1 {m['acc1']:.2f} acc5 {m['acc5']:.2f} "
                          f"lr {m['lr']:.5f} feat_norm {m['feat_norm']:.3f}",
                          flush=True)
                now = time.perf_counter()
                step_seconds += [(now - end) / n] * n
                end = now
                if preempted["set"]:
                    break
            epoch_losses = [float(x) for v in losses
                            for x in v.reshape(-1).tolist()]
            all_losses += epoch_losses
            train_loss = float(np.mean(epoch_losses))
            if preempted["set"]:
                checkpoint_manager.save(state, epoch - 1, train_loss)
                print(f"### Preemption: saved checkpoint at epoch "
                      f"{epoch - 1} step {i} — resume with "
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
        # before the graph is freed, which takes the card a while
        wall = time.perf_counter() - t_start
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if runner is not None:
            runner.close(state)
    return FitResult(state=state, head_cfg=head_cfg,
                     min_train_loss=min_train_loss, epochs_run=cfg.epochs,
                     steps_per_sec=steps_run / max(wall, 1e-9),
                     images_per_sec=total_images / max(wall, 1e-9),
                     losses=all_losses, step_seconds=step_seconds,
                     preempted=preempted["set"],
                     **({} if runner is None else {
                         "capture_seconds": runner.capture_seconds,
                         "replays": runner.replays,
                         "replay_launches": runner.replay_launches}))
