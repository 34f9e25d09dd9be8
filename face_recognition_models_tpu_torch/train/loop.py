"""The epoch loop. Port of `fit` from face_recognition_models_tpu/train/
loop.py, with checkpoints and resume, the optimizer factory, clipping,
gradient accumulation, the model EMA, the frozen trunk, the augmentations,
distillation and Partial-FC (`cfg.partial_fc`, train/partial_fc.py, with
the JAX loop's checks and its dense fallback), and the ('data', 'model')
mesh.

Under a world of more than one rank (parallel/dist.initialize) `fit` builds
the mesh of `cfg.mesh` by itself, as the JAX `fit` does with more than one
device: the loader gives the rank's rows (a shard of cfg.batch_size //
data per step, by the rank's data coordinate), the state is sharded by the
rules of parallel/sharding.py, the step averages the gradients over the
data group, and with a model axis the fused head (or, with
`cfg.partial_fc`, train/partial_fc_sharded.py) runs per class shard. The
losses are the global batch's on every rank; rank 0 alone prints and
writes the checkpoints, and every rank takes the same stop decision: the
ranks vote on a signal at `print_freq` steps and at each epoch's end, so a
preempted world stops at the first of those after the signal.
`scan_steps` K > 1 runs a chunk's K steps one at a time (gloo collectives
cannot be captured in a CUDA graph); the results are the same.

Metrics stay on the device and are read (which waits for the card) only at
`print_freq` steps and at the end of each epoch. A print step prints the
JAX loop's line (utils/logging.MetricTracker over TRAIN_COLUMNS: step time,
data time, img/s and the step's metrics, each with its running average
over the epoch's print steps) and hands the step's metrics and the epoch to
`logger.log` (utils/experiment.ExperimentLogger) at the global step. Heads that need a second
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
continue_train='latest') and returns. `hooks(epoch=, state=, train_loss=)`
runs at the end of each epoch, after its checkpoints (the periodic
verification of evaluation/periodic.py).
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.ops.image_ops import degrade_images
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.parallel import dist as pdist
from face_recognition_models_tpu_torch.train.graphed import (
    ChunkRunner,
    make_chunk_fn,
)
from face_recognition_models_tpu_torch.train.partial_fc import (
    make_partial_fc_train_step,
    num_sampled_classes,
)
from face_recognition_models_tpu_torch.train.partial_fc_sharded import (
    make_sharded_partial_fc_train_step,
)
from face_recognition_models_tpu_torch.train.schedules import get_schedule
from face_recognition_models_tpu_torch.train.state import create_train_state
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.device import resolve_device
from face_recognition_models_tpu_torch.utils.logging import (
    TRAIN_COLUMNS,
    MetricTracker,
)


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


def load_teacher(distill: cfg_lib.DistillConfig, feature_dim: int,
                 device: torch.device, image_size: int = 112
                 ) -> torch.nn.Module:
    """The frozen teacher a previous `train` run saved in
    distill.checkpoint_dir (checkpoint/manager.restore_backbone, artifact
    distill.which), as `get_backbone(distill.backbone)` builds it: bf16
    convolutions, fp32 BatchNorm. A checkpoint that does not load raises."""
    from face_recognition_models_tpu_torch.checkpoint import (
        restore_backbone)

    module = get_backbone(distill.backbone, embed_dim=feature_dim,
                          image_size=image_size)
    module.load_state_dict(restore_backbone(distill.checkpoint_dir,
                                            distill.which))
    return module


def _prepare_teacher(cfg: cfg_lib.TrainConfig, head_cfg, teacher,
                     device: torch.device):
    """The teacher of the run on `device` in eval mode with no gradient,
    or None; the JAX package's checks (train/loop.py:172-219)."""
    distill = cfg.distill
    if teacher is not None and distill.weight <= 0.0:
        raise ValueError(
            "teacher provided but cfg.distill.weight == 0; set a positive "
            "--distill-weight to enable distillation")
    if distill.weight <= 0.0:
        return None
    if teacher is None:
        if not distill.checkpoint_dir:
            raise ValueError(
                "distill.weight > 0 needs a teacher: pass teacher=<backbone "
                "module> or set --distill-dir <checkpoint dir>")
        teacher = load_teacher(distill, head_cfg.feature_dim, device,
                               cfg.data.image_size)
    teacher = to_device(teacher, device).eval().requires_grad_(False)
    size = cfg.data.image_size
    with torch.no_grad():
        d_t = teacher(torch.zeros((1, size, size, 3),
                                  device=device)).shape[-1]
    if d_t != head_cfg.feature_dim:
        raise ValueError(
            f"teacher embedding dim {d_t} != student feature dim "
            f"{head_cfg.feature_dim}; distill_loss needs matching "
            "embedding spaces")
    if cfg.freeze_backbone:
        raise ValueError(
            "freeze_backbone with distillation is contradictory: the KD "
            "loss only reaches the (frozen) trunk")
    return teacher


def partial_fc_classes(cfg: cfg_lib.TrainConfig, head_cfg,
                       model: int = 1) -> int:
    """The Partial-FC sample size C_s of cfg, or 0 for the dense path: the
    JAX loop's refusals (train/loop.py:126-130, 181-185, 211-216,
    228-242) and its dense fallback (:243-258). With a model axis of
    `model` > 1 the size is per class shard, and the fallback is judged on
    the shard's C / model classes."""
    ratio = float(cfg.partial_fc)
    if ratio <= 0.0:
        return 0
    if cfg.grad_accum > 1:
        raise ValueError(
            "grad_accum requires --partial-fc 0: Partial-FC's manual "
            "sampled-column update applies immediately and cannot "
            "accumulate")
    if cfg.distill.weight > 0.0:
        raise ValueError(
            "distillation requires --partial-fc 0 (the sampled-"
            "classifier step does not carry the teacher forward)")
    if cfg.freeze_backbone:
        raise ValueError(
            "freeze_backbone is not supported with partial_fc (the "
            "sampled-column step has no frozen-trunk path yet); "
            "use --partial-fc 0 or --no freeze")
    if cfg.optimizer.name != "sgd":
        raise ValueError(
            f"partial_fc requires optimizer 'sgd' (got "
            f"'{cfg.optimizer.name}'): the sampled classifier columns "
            "are updated by a manual torch-SGD rule (train/partial_fc"
            ".py); use --partial-fc 0 or --optimizer sgd")
    if cfg.optimizer.clip_grad_norm > 0.0:
        raise ValueError(
            "clip_grad_norm is not supported with partial_fc (the "
            "sampled classifier columns bypass the optimizer); "
            "use --clip-grad-norm 0 or --partial-fc 0")
    num_classes = head_cfg.num_classes
    c_min = num_classes // max(model, 1)
    n_sampled = num_sampled_classes(c_min, ratio, cfg.batch_size)
    if cfg.batch_size >= c_min or n_sampled >= c_min:
        # sampling cannot beat dense when the sample must cover (almost)
        # every class
        shard = "" if model <= 1 else f" (per-shard {c_min})"
        print(f"[partial_fc] C={num_classes}{shard} too small for batch "
              f"{cfg.batch_size} / ratio {ratio} — using the dense path")
        return 0
    return n_sampled


def make_recipe(cfg: cfg_lib.TrainConfig, head_cfg, device: torch.device,
                schedule=None, teacher=None, warm_start=None, mesh=None):
    """(head, state, step) of cfg's recipe on `device`: the train state
    (optimizer, accumulation, EMA) and the train step with the schedule,
    augmentations, teacher (given, or loaded from cfg.distill) and frozen
    trunk cfg names, or Partial-FC's step (partial_fc_classes). `warm_start`,
    a backbone state_dict, replaces the initial backbone (and the EMA's copy
    of it), as the JAX `fit`'s warm_start does. `mesh` makes them one
    rank's (module docstring)."""
    if cfg.backbone.lower() == "inception_v3":
        raise ValueError(
            "fit cannot train inception_v3: its dropout would need the "
            "step's generator, which the JAX train loop gives only to "
            "efficientnet_b0 and mobilenet_v2 (face_recognition_models_tpu/"
            "train/loop.py:169), so JAX `fit` fails there with no dropout "
            "generator. inception_v3 embeds, exports and serves; the "
            "triplet path trains it (`facenet --backbone inception_v3`, "
            "triplet/train.py)")
    model = 1 if mesh is None else mesh.model
    n_sampled = partial_fc_classes(cfg, head_cfg, model)
    teacher = _prepare_teacher(cfg, head_cfg, teacher, device)
    kw = {"partial_fc": True} if n_sampled else {}
    if mesh is not None:
        kw["mesh"] = mesh
    _, head, state = create_train_state(cfg, head_cfg, device, **kw)
    if warm_start is not None:
        state.backbone.load_state_dict(warm_start)
        if state.ema is not None:
            for e, p in zip(state.ema, state.params()):
                e.copy_(p.detach())
    data = cfg.data
    augment = dict(mean=data.mean, std=data.std, device=device,
                   horizontal_flip=data.horizontal_flip,
                   crop_pad=data.crop_pad, color_jitter=data.color_jitter,
                   random_erasing=data.random_erasing)
    if n_sampled:
        opt = cfg.optimizer
        common = dict(
            lr_schedule=schedule, momentum=opt.momentum,
            weight_decay=opt.weight_decay, nesterov=opt.nesterov,
            lambda_g=cfg.lambda_g, logq_correction=cfg.partial_fc_logq,
            model_ema=cfg.model_ema, **augment)
        if model > 1:
            step_fn = make_sharded_partial_fc_train_step(
                head, head_cfg, n_sampled, mesh, **common)
        else:
            step_fn = make_partial_fc_train_step(head, head_cfg, n_sampled,
                                                 mesh=mesh, **common)
        return head, state, step_fn
    step_fn = make_train_step(
        head, head_cfg, lr_schedule=schedule,
        use_fused_head=cfg.use_fused_head, lambda_g=cfg.lambda_g,
        teacher=teacher, distill_weight=cfg.distill.weight,
        distill_mode=cfg.distill.mode, freeze_backbone=cfg.freeze_backbone,
        grad_accum=cfg.grad_accum, model_ema=cfg.model_ema, mesh=mesh,
        **augment)
    return head, state, step_fn


def fit(cfg: cfg_lib.TrainConfig, loader, logger=None, device=None,
        head_cfg=None, checkpoint_manager: Optional[Any] = None,
        teacher: Optional[torch.nn.Module] = None,
        hooks: Optional[Callable] = None,
        warm_start: Optional[dict] = None, mesh=None) -> FitResult:
    """Train for cfg.epochs over `loader` (any object with steps_per_epoch()
    and epoch(i) -> iterator of (uint8 NHWC images, int labels)).

    `logger` (anything with log(metrics, step=)) gets each print step's
    metrics, as the module docstring says.

    With `checkpoint_manager` (checkpoint/manager.CheckpointManager) the
    run saves and resumes as the module docstring says; a resumed run
    takes cfg.epochs more epochs from the one after the checkpoint's.
    `teacher` (a backbone module; needs cfg.distill.weight > 0) is the
    in-memory alternative to cfg.distill.checkpoint_dir. `hooks` is
    called at each epoch's end (module docstring). `warm_start` is a
    backbone state_dict to start from (make_recipe). `mesh`
    (parallel/mesh.Mesh) defaults to make_mesh(cfg.mesh) in a world of
    more than one rank; `loader` then yields the rank's rows.
    Runs on the card unless device='cpu' is passed; raises without one.
    """
    device = resolve_device(device)
    if mesh is None and pdist.world_size() > 1:
        from face_recognition_models_tpu_torch.parallel import make_mesh
        mesh = make_mesh(cfg.mesh)
    writer = coll.is_writer(mesh)
    if head_cfg is None:
        head_cfg = cfg_lib.make_head_config(cfg.head,
                                            num_classes=cfg.num_classes)
    steps_per_epoch = loader.steps_per_epoch()
    if steps_per_epoch <= 0:
        raise ValueError("loader yields no full batches")
    scan_k = max(1, int(cfg.scan_steps))
    if mesh is not None and scan_k > 1:
        if writer:
            print(f"[mesh] scan_steps {scan_k}: a chunk's steps run one at "
                  "a time (no CUDA graph of collectives under a mesh)")
        scan_k = 1
    schedule = get_schedule(cfg.schedule, cfg.optimizer.learning_rate,
                            steps_per_epoch, cfg.epochs, device=device)
    head, state, step_fn = make_recipe(cfg, head_cfg, device, schedule,
                                       teacher, warm_start, mesh)
    runner = (ChunkRunner(make_chunk_fn(step_fn, head.requires_minput),
                          scan_k, device) if scan_k > 1 else None)

    min_train_loss = float("inf")
    start_epoch = 1
    if checkpoint_manager is not None:
        if cfg.continue_train is None:
            checkpoint_manager.reset(mesh=mesh)
        else:
            restored, start_epoch, loss = checkpoint_manager.restore(
                state, mode=cfg.continue_train, mesh=mesh)
            if restored is not None:
                # a non-finite saved loss must not block every later best
                min_train_loss = loss if np.isfinite(loss) else float("inf")
                if writer:
                    print(f"### Resuming from epoch {start_epoch - 1} "
                          f"(train_loss={loss:.6f}) ###")

    stage = HostStaging(device, buffers=2 * scan_k)
    preempted = {"set": False}
    previous = (_install_preemption_handlers(preempted)
                if checkpoint_manager is not None else {})
    last_epoch = cfg.epochs + start_epoch - 1
    data = coll.data_size(mesh)   # images_per_sec counts the global batch
    all_losses, step_seconds = [], []
    total_images = steps_run = 0
    global_step = (start_epoch - 1) * steps_per_epoch
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

    def stop_now(vote_here):
        """Whether to stop after this step. Without a mesh, once a signal
        has come; under one, the ranks vote only where `vote_here` is true
        on every rank alike (print steps and the epoch's end), so each
        stops at the same step without a host sync every step."""
        if mesh is None or checkpoint_manager is None:
            return preempted["set"]
        return vote_here and coll.any_rank(preempted["set"], mesh)

    try:
        for epoch in range(start_epoch, last_epoch + 1):
            tracker = MetricTracker(
                steps_per_epoch, TRAIN_COLUMNS,
                prefix=f"Epoch: [{epoch}/{last_epoch}]")
            losses = []   # per-step 0-d tensors and [K] chunk vectors
            i = 0         # steps done this epoch
            stop = False
            for work in _chunks(loader.epoch(epoch), scan_k):
                n = len(work)
                data_t = time.perf_counter() - end
                metrics = (run_chunk(work) if runner is not None
                           and n == scan_k else run_single(*work[0]))
                step_t = time.perf_counter() - end
                losses.append(metrics["loss"])
                first, i = i, i + n
                global_step += n
                batch = len(work[0][0])
                total_images += batch * n * data
                steps_run += n
                print_step = first % cfg.print_freq < n
                if writer and print_step:
                    # reading the metrics waits for the card
                    m = {k: float(v.reshape(-1)[-1])
                         for k, v in metrics.items()}
                    tracker.observe({"batch_time": step_t / n,
                                     "data_time": data_t / n,
                                     "throughput": batch * n
                                     / max(step_t, 1e-9)})
                    tracker.observe(m, weight=batch)
                    print(tracker.line(i - 1), flush=True)
                    if logger is not None:
                        logger.log({**m, "epoch": epoch}, step=global_step)
                now = time.perf_counter()
                step_seconds += [(now - end) / n] * n
                end = now
                stop = stop_now(print_step)
                if stop:
                    break
            stop = stop or stop_now(True)
            preempted["set"] = preempted["set"] or stop
            epoch_losses = [float(x) for v in losses
                            for x in v.reshape(-1).tolist()]
            all_losses += epoch_losses
            train_loss = float(np.mean(epoch_losses))
            if stop:
                checkpoint_manager.save(state, epoch - 1, train_loss,
                                        mesh=mesh)
                if writer:
                    print(f"### Preemption: saved checkpoint at epoch "
                          f"{epoch - 1} step {i} — resume with "
                          f"continue_train='latest' ###", flush=True)
                break
            if checkpoint_manager is not None:
                if train_loss < min_train_loss:
                    min_train_loss = train_loss
                    checkpoint_manager.save(state, epoch, train_loss,
                                            is_best=True, mesh=mesh)
                    if writer:
                        print(f"New best model saved: {train_loss:.6f}")
                checkpoint_manager.save(state, epoch, train_loss, mesh=mesh)
            else:
                min_train_loss = min(min_train_loss, train_loss)
            if hooks is not None:
                hooks(epoch=epoch, state=state, train_loss=train_loss)
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
