"""FaceNet triplet training. Port of
face_recognition_models_tpu/triplet/train.py.

PK batches (P identities x K images) -> the embedding trunk in train mode
-> L2 normalisation -> on-device semi-hard mining -> triplet loss -> SGD,
in one step that reads nothing back to the host (the reference's
train_one_epoch, FaceNet/main.py:133-146, whose __main__ is a stub).

The model trained is the bare trunk of `models.get_backbone` at
`cfg.embed_dim` (normalisation is applied in the step and again by every
consumer; it is idempotent), so the final artifact `<model>_final` is the
backbone's state_dict that `eval`, `embed` and `export --checkpoint-dir`
read. Every trunk that draws dropout masks gets the state's generator
(`rng=`) in the step, inception_v3 included, as the JAX step gives every
trunk its dropout key (JAX triplet/train.py:67-70); the mining's Gumbel
noise comes from the same generator. Checkpoints go through the port's
CheckpointManager: rotating epoch files, best-by-train-loss, resume.

With `mesh=` the step is data-parallel over the mesh's 'data' axis: each
rank runs the trunk on its rows of the PK batch (BatchNorm over the global
batch), the embeddings are gathered over the data group before the mining
(the gather is differentiable), so the semi-hard mask stays a global-batch
computation as in the JAX step, and the gradients are averaged over the
group; the state is replicated. `train_facenet(mesh=)` gives each rank its
rows of every global PK batch; rank 0 prints and writes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from face_recognition_models_tpu_torch.config import FaceNetConfig
from face_recognition_models_tpu_torch.data.sampler import PKBatchSampler
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.ops.image_ops import (
    normalization_constants,
)
from face_recognition_models_tpu_torch.ops.mining import mined_triplet_loss
from face_recognition_models_tpu_torch.ops.normalize import l2_normalize
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TripletTrainState:
    """What a triplet step reads and changes: the trunk (parameters and
    BatchNorm buffers), its optimizer, the global step (`step` on the host,
    `count` on the device) and the step generator `rng` (dropout masks and
    the mining's noise). It has no head; the attributes below are what
    checkpoint/manager.py reads of a margin-head TrainState."""

    backbone: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    rng: Optional[torch.Generator] = None
    count: Optional[torch.Tensor] = None
    kernel_w = None
    kernel_mom = None
    head_state = None
    ema = None

    def __post_init__(self):
        if self.count is None:
            device = next(self.backbone.parameters()).device
            self.count = torch.full((), self.step, dtype=torch.int64,
                                    device=device)

    def set_step(self, step: int) -> None:
        """Set the global step, on the host and on the device."""
        self.step = step
        self.count.fill_(step)


def make_triplet_train_step(margin: float, mean=(0.5, 0.5, 0.5),
                            std=(0.5, 0.5, 0.5), device=None,
                            mesh=None) -> Callable:
    """step(state, images, labels) -> (state, metrics): one triplet step
    over `state.backbone` (a trunk; an already-normalising module works
    too). It updates `state` in place; the metrics, `loss` and `triplets`
    (the mined valid anchor-positive pairs), stay on the device. With
    `mesh`, images and labels are the rank's rows (module docstring). Runs
    on the card unless device='cpu' is passed."""
    device = resolve_device(device)
    if device.type == "cuda":
        # the mining's pairwise product stays IEEE fp32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
    scale, bias = normalization_constants(mean, std, device=device)

    def train_step(state: TripletTrainState, images, labels):
        with coll.using(mesh):
            return one_step(state, images, labels)

    def one_step(state, images, labels):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * scale + bias
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        state.backbone.train()
        kw = ({"rng": state.rng}
              if getattr(state.backbone, "takes_rng", False) else {})
        feats = state.backbone(images, **kw).to(torch.float32)
        emb = coll.gather_rows(l2_normalize(feats, dim=1))
        loss, mined = mined_triplet_loss(emb, coll.gather_rows(labels),
                                         margin, state.rng)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        coll.average_gradients(list(state.backbone.parameters()))
        state.optimizer.step()
        with torch.no_grad():
            state.count.add_(1)
        state.step += 1
        return state, {"loss": loss.detach(),
                       "triplets": mined.valid.sum()}

    return train_step


@dataclasses.dataclass
class TripletFitResult:
    state: TripletTrainState
    model: Any
    losses: list
    images_per_sec: float
    start_epoch: int = 1          # > 1 when the run resumed
    checkpoint_dir: Optional[str] = None
    # the mined valid anchor-positive pairs of each step
    triplets: list = dataclasses.field(default_factory=list)


class _ArrayPKBatches:
    """In-memory PK batch source with the Loader epoch API (the synthetic
    and test path); `data.pipeline.PKLoader` is the streaming twin."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 p: int, k: int, seed: int):
        self._images = images
        self._labels = np.asarray(labels, np.int32)
        self._sampler = PKBatchSampler(labels, p, k, seed=seed)

    def steps_per_epoch(self) -> int:
        return len(self._sampler)

    def epoch(self, epoch: int = 0
              ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
        for idx in self._sampler.epoch(epoch):
            yield self._images[idx], self._labels[idx]


def train_facenet(cfg: FaceNetConfig, images: Optional[np.ndarray] = None,
                  labels: Optional[np.ndarray] = None,
                  epochs: int = 1, image_size: int = 112, seed: int = 0,
                  verbose: bool = True, *, loader=None,
                  checkpoint_dir: Optional[str] = None,
                  model_name: Optional[str] = None,
                  resume: bool = False, keep: int = 3,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None, mesh=None) -> TripletFitResult:
    """Train the embedding trunk with PK sampling (the train_one_epoch flow
    of FaceNet/main.py:133-146).

    Data: in-memory `(images, labels)` arrays or a `loader` with the epoch
    API (PK batches: `data.pipeline.PKLoader` / `data.recordio.PKRecLoader`
    stream a tree or a .rec). The trunk's weights come from
    `models.resnet.init_weights` with a generator seeded `seed`, the step
    generator is seeded `seed + 1`. `checkpoint_dir` turns on rotating
    per-epoch checkpoints, best-by-train-loss, resume (`resume=True`
    continues from the latest epoch) and the final `<model>_final`, the
    backbone's state_dict. Losses are read once an epoch. `mesh` makes the
    step data-parallel (module docstring): p * k must divide over the mesh
    'data' axis. Runs on the card unless device='cpu' is passed."""
    device = resolve_device(device)
    if mesh is not None and (cfg.p * cfg.k) % mesh.data:
        raise ValueError(
            f"PK batch {cfg.p}*{cfg.k} must divide the mesh data axis "
            f"({mesh.data})")
    writer = coll.is_writer(mesh)
    verbose = verbose and writer
    if loader is None:
        if images is None or labels is None:
            raise ValueError("provide (images, labels) arrays or loader=")
        loader = _ArrayPKBatches(images, labels, cfg.p, cfg.k, seed)

    model = get_backbone(cfg.backbone, embed_dim=cfg.embed_dim, dtype=dtype,
                         image_size=image_size)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = to_device(model, device)
    optimizer = get_optimizer("sgd", model.parameters(), cfg.learning_rate,
                              momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    state = TripletTrainState(
        backbone=model, optimizer=optimizer,
        rng=torch.Generator(device=device).manual_seed(seed + 1))

    mgr = None
    start_epoch, best_loss = 1, float("inf")
    if checkpoint_dir is not None:
        from face_recognition_models_tpu_torch.checkpoint import (
            CheckpointManager)
        mgr = CheckpointManager(checkpoint_dir,
                                model_name or f"facenet_{cfg.backbone}",
                                keep=keep)
        if resume:
            restored, start_epoch, best_loss = mgr.restore(state, "latest",
                                                           mesh=mesh)
            if restored is not None and verbose:
                print(f"facenet resume: epoch {start_epoch} "
                      f"(best loss {best_loss:.4f})")
        else:
            mgr.reset(mesh=mesh)

    step = make_triplet_train_step(cfg.margin, device=device, mesh=mesh)
    rows = slice(None)
    if mesh is not None:
        n = cfg.p * cfg.k // mesh.data
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    losses, triplets = [], []
    total = 0
    t0 = time.time()
    for epoch in range(start_epoch, epochs + 1):
        metrics = []
        for batch_images, batch_labels in loader.epoch(epoch - 1):
            state, m = step(state, batch_images[rows],
                            np.asarray(batch_labels, np.int32)[rows])
            # kept on the device: reading each step would wait for the card
            metrics.append(m)
            total += len(batch_labels)
        epoch_losses = [float(m["loss"]) for m in metrics]
        triplets += [int(m["triplets"]) for m in metrics]
        losses.extend(epoch_losses)
        epoch_loss = float(np.mean(epoch_losses)) if epoch_losses else np.inf
        if verbose:
            print(f"facenet epoch {epoch}/{epochs}: loss {epoch_loss:.4f}")
        if mgr is not None:
            mgr.save(state, epoch, epoch_loss, mesh=mesh)
            if epoch_loss < best_loss:
                best_loss = epoch_loss
                mgr.save(state, epoch, epoch_loss, is_best=True, mesh=mesh)
    wall = max(time.time() - t0, 1e-9)
    if mgr is not None and writer:
        mgr.save_final(state.backbone.state_dict())
    return TripletFitResult(state=state, model=model, losses=losses,
                            images_per_sec=total / wall,
                            start_epoch=start_epoch,
                            checkpoint_dir=mgr.directory if mgr else None,
                            triplets=triplets)
