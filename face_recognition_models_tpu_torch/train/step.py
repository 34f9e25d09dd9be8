"""Train and eval steps. Port of face_recognition_models_tpu/train/step.py.

One train step: uint8 NHWC batch -> normalise on the device -> backbone in
train mode -> margin head + cross-entropy -> backward -> SGD update with the
lr the schedule gives for the step count before the update. The fused path
(default) runs the margin + CE through the CUDA kernels of
ops/fused_head.py and never materialises the [N, C] logits; the eager path
is the [N, C] head of heads/margins.py. QAFace's degraded view
(`minput_images`) goes through the same backbone in train mode, with its
BatchNorm statistics dropped as the JAX step drops them.
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
    normalize_images,
)
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.utils.device import resolve_device


def make_train_step(head, head_cfg, lr_schedule: Optional[Callable] = None,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                    use_fused_head: bool = True,
                    device=None) -> Callable:
    """Build step(state, images, labels, minput_images=None)
    -> (state, metrics).

    The step updates `state` in place (module parameters, BatchNorm buffers,
    optimizer slots, step count) and returns it. Metrics are 0-d tensors on
    the device, left unsynchronised. Without `lr_schedule` the optimizer's
    own lr stays. Runs on the card unless device='cpu' is passed.
    """
    device = resolve_device(device)
    if use_fused_head and not fused_supported(head_cfg.name):
        raise ValueError(f"head '{head_cfg.name}' has no fused-kernel path")
    if device.type == "cuda":
        # the head's fp32 products must stay IEEE fp32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False

    def prepare(images):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = normalize_images(images, mean, std)
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
        if use_fused_head:
            out = fused_apply(head_cfg, state.kernel_w, feats, labels,
                              state.head_state, minput=minput_feats)
            loss_id, acc1, acc5 = out.loss_id, out.acc1, out.acc5
        else:
            out = head.apply(head_cfg, state.kernel_w, feats, labels,
                             state.head_state, minput=minput_feats)
            loss_id = mean_cross_entropy(out.logits, labels)
            acc1, acc5 = topk_accuracy(out.pre_logits, labels)
        lr = (lr_schedule(state.step) if lr_schedule is not None
              else state.optimizer.param_groups[0]["lr"])
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss_id.backward()
        state.optimizer.step()
        # the new state is computed from tensors with grad history; kept
        # undetached it would chain every step's graph to the next
        state.head_state = _detached(out.state)
        state.step += 1
        metrics = {"loss": loss_id.detach(), "acc1": acc1, "acc5": acc5,
                   "lr": torch.tensor(lr),
                   "feat_norm": out.norms.detach().mean()}
        return state, metrics

    return train_step


def _detached(head_state):
    if head_state is None:
        return None
    return type(head_state)(*(x.detach() for x in head_state))


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
