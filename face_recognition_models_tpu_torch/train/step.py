"""Train and eval steps. Port of face_recognition_models_tpu/train/step.py.

One train step: uint8 NHWC batch -> normalise on the device -> backbone in
train mode -> margin head + cross-entropy -> backward -> SGD update with the
lr the schedule gives for the step count before the update. The fused path
(default) runs the margin + CE through the CUDA kernels of
ops/fused_head.py and never materialises the [N, C] logits; the eager path
is the [N, C] head of heads/margins.py. The loss is the CE plus lambda_g
times the head's auxiliary loss (MagFace's magnitude regulariser); heads
with `requires_rng` draw from the state's generator `state.rng`. QAFace's
degraded view (`minput_images`) goes through the same backbone in train
mode, with its BatchNorm statistics dropped as the JAX step drops them.

The step reads nothing back to the host and keeps every tensor of the state
where it is: it normalises with constants made once, takes the lr from the
schedule of the device count `state.count`, writes it into `state.lr` for
the update, and copies the head's new state into the head-state tensors.
So the same function runs eagerly and inside a CUDA graph of K steps
(train/graphed.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from face_recognition_models_tpu_torch.heads.fused_adapter import (
    fused_apply,
    fused_supported,
)
from face_recognition_models_tpu_torch.models.resnet import (
    running_stats_frozen,
)
from face_recognition_models_tpu_torch.ops.image_ops import (
    normalization_constants,
)
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.utils.device import resolve_device


def make_train_step(head, head_cfg, lr_schedule: Optional[Callable] = None,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                    use_fused_head: bool = True,
                    lambda_g: float = 0.0, device=None) -> Callable:
    """Build step(state, images, labels, minput_images=None)
    -> (state, metrics).

    The step updates `state` in place (module parameters, BatchNorm buffers,
    optimizer slots, head state, step count, lr) and returns it. Metrics are
    0-d tensors on the device, left unsynchronised. `lr_schedule` maps the
    step count (a 0-d device tensor) to the lr; without it the optimizer's
    own lr stays. Runs on the card unless device='cpu' is passed.
    """
    device = resolve_device(device)
    if use_fused_head and not fused_supported(head_cfg.name):
        raise ValueError(f"head '{head_cfg.name}' has no fused-kernel path")
    if device.type == "cuda":
        # the head's fp32 products must stay IEEE fp32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
    # made once: a copy from the host per step could not be captured
    scale, bias = normalization_constants(mean, std, device=device)

    def prepare(images):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * scale + bias
        return images

    def train_step(state: TrainState, images, labels, minput_images=None):
        images = prepare(images)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        state.backbone.train()
        feats = state.backbone(images).to(torch.float32)
        minput_feats = None
        if minput_images is not None:
            # gradients flow through this view too, as in the JAX step
            with running_stats_frozen(state.backbone):
                minput_feats = state.backbone(prepare(minput_images)).to(
                    torch.float32)
        rng = state.rng if head.requires_rng else None
        if use_fused_head:
            out = fused_apply(head_cfg, state.kernel_w, feats, labels,
                              state.head_state, rng=rng, minput=minput_feats)
            loss_id, acc1, acc5 = out.loss_id, out.acc1, out.acc5
        else:
            out = head.apply(head_cfg, state.kernel_w, feats, labels,
                             state.head_state, rng=rng, minput=minput_feats)
            loss_id = mean_cross_entropy(out.logits, labels)
            acc1, acc5 = topk_accuracy(out.pre_logits, labels)
        loss_mag = lambda_g * out.loss_g
        loss = loss_id + loss_mag
        # the lr of the count before this update, as optax's schedule reads
        lr = (lr_schedule(state.count) if lr_schedule is not None
              else torch.full((), state.optimizer.param_groups[0]["lr"],
                              dtype=torch.float32, device=device))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            state.lr.copy_(lr)
            state.optimizer.step(state.lr)
            # after the backward, which may still read the old state
            _copy_state(state.head_state, out.state)
            state.count.add_(1)
        state.step += 1
        metrics = {"loss": loss.detach(), "loss_id": loss_id.detach(),
                   "loss_mag": loss_mag.detach(), "acc1": acc1, "acc5": acc5,
                   "lr": lr, "feat_norm": out.norms.detach().mean()}
        return state, metrics

    return train_step


def _copy_state(head_state, new_state) -> None:
    """Write a head's new state into its state tensors (same shapes and
    dtypes), so their addresses never change."""
    if head_state is None:
        return
    for x, y in zip(head_state, new_state, strict=True):
        x.copy_(y)


def make_eval_step(backbone, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                   device=None) -> Callable:
    """Embedding extraction: images -> [N, D] fp32 embeddings with the
    running BatchNorm statistics. Runs on the card unless device='cpu'.
    The normalisation constants are made on the device once, so a step on
    a batch already there copies nothing from the host (and can be
    captured in a CUDA graph)."""
    device = resolve_device(device)
    scale, bias = normalization_constants(mean, std, device=device)

    @torch.no_grad()
    def eval_step(images):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * scale + bias
        backbone.eval()
        return backbone(images).to(torch.float32)

    return eval_step
