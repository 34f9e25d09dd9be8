"""Train and eval steps. Port of face_recognition_models_tpu/train/step.py.

One train step: uint8 NHWC batch -> normalise on the device -> the
augmentations (ops/image_ops.apply_augmentations) -> the teacher's
embeddings, when distilling (eval mode, no gradient, on the augmented
batch) -> backbone in train mode (with `freeze_backbone` in eval mode with
no backward) -> margin head + cross-entropy (+ the distillation loss) ->
backward -> the optimizer's update (clipping, rule, accumulation: train/
optim.py, train/accum.py) with the lr the schedule gives for the step count
before the update -> the model EMA -> the head state. The fused path
(default) runs the margin + CE through the CUDA kernels of
ops/fused_head.py and never materialises the [N, C] logits; the eager path
is the [N, C] head of heads/margins.py. The loss is the CE plus lambda_g
times the head's auxiliary loss (MagFace's magnitude regulariser); heads
with `requires_rng` draw from the state's generator `state.rng`, and so
do the dropout masks of the trunks that have them. QAFace's
degraded view (`minput_images`) goes through the same backbone in train
mode, with its BatchNorm statistics dropped as the JAX step drops them.

The step reads nothing back to the host and keeps every tensor of the state
where it is: it normalises with constants made once, takes the lr from the
schedule of the device count `state.count`, writes it into `state.lr` for
the update, and copies the head's new state into the head-state tensors.
So the same function runs eagerly and inside a CUDA graph of K steps
(train/graphed.py). Under grad_accum = K the update's lr is the schedule's
at the start of the micro-step's K-cycle, schedule((count // K) * K), and
the metric `lr` the schedule's at the count, as in the JAX package.

With `mesh` (parallel/mesh.Mesh) the step is one rank's share of the global
step: the batch is the rank's rows, the kernel and the head memories its
class shard. The step runs under `collectives.using(mesh)`, so BatchNorm,
the heads' batch statistics and every per-row draw are the global batch's;
the fused head combines its class shards over the model group
(parallel/sharded_fused.py); the eager head (`eager_apply`) runs on the
rank's kernel and head-state shards, its [N, C/m] logits, loss and
accuracy combined over the model group, so no rank holds the whole kernel
or any [N, C] tensor; the gradients are averaged over the data group
before the update, and the metrics are the global batch's means on every
rank.
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
    apply_augmentations,
    normalization_constants,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.utils.device import resolve_device


def distill_loss(student_feats: torch.Tensor, teacher_feats: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Embedding-space distillation penalty. cosine: mean(1 - cos(s, t)) on
    L2-normalised embeddings (+1e-12 on the norms); mse: the mean squared
    L2 distance of the raw embeddings."""
    if mode == "cosine":
        s = student_feats / (torch.linalg.vector_norm(
            student_feats, dim=1, keepdim=True) + 1e-12)
        t = teacher_feats / (torch.linalg.vector_norm(
            teacher_feats, dim=1, keepdim=True) + 1e-12)
        return torch.mean(1.0 - torch.sum(s * t, dim=1))
    if mode == "mse":
        return torch.mean(torch.sum((student_feats - teacher_feats) ** 2,
                                    dim=1))
    raise ValueError(f"unknown distill mode '{mode}' (cosine | mse)")


def eager_apply(head, head_cfg, kernel, feats, labels, head_state, rng=None,
                minput=None, mesh=None):
    """The eager head + mean CE + top-1 / top-5 -> (HeadOutput, loss_id,
    acc1, acc5). With a model axis in `mesh` (or the active mesh), kernel
    and head_state are the rank's class shards and the logits its
    [N, C/m] columns; the loss and the accuracy combine the shards over
    the model group. A head whose logits do not cover its shard exactly
    raises: nothing falls back to the whole kernel."""
    with coll.using(coll.active() if mesh is None else mesh):
        out = head.apply(head_cfg, kernel, feats, labels, head_state,
                         rng=rng, minput=minput)
        model = coll.model_size()
        if out.logits.shape[1] * model != head_cfg.num_classes:
            raise ValueError(
                f"head '{head_cfg.name}' gave {out.logits.shape[1]} logit "
                f"columns on a shard of {head_cfg.num_classes} classes over "
                f"{model} model ranks")
        loss_id = mean_cross_entropy(out.logits, labels)
        acc1, acc5 = topk_accuracy(out.pre_logits, labels)
    return out, loss_id, acc1, acc5


def make_train_step(head, head_cfg, lr_schedule: Optional[Callable] = None,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                    use_fused_head: bool = True,
                    lambda_g: float = 0.0, device=None,
                    horizontal_flip: bool = False, crop_pad: int = 0,
                    color_jitter: float = 0.0, random_erasing: float = 0.0,
                    teacher: Optional[torch.nn.Module] = None,
                    distill_weight: float = 0.0,
                    distill_mode: str = "cosine",
                    freeze_backbone: bool = False, grad_accum: int = 1,
                    model_ema: float = 0.0, mesh=None) -> Callable:
    """Build step(state, images, labels, minput_images=None)
    -> (state, metrics).

    The step updates `state` in place (module parameters, BatchNorm buffers,
    optimizer state, head state, step count, lr, EMA) and returns it.
    Metrics are 0-d tensors on the device, left unsynchronised.
    `lr_schedule` maps the step count (a 0-d device tensor) to the lr;
    without it the optimizer's own lr stays. The augmentations draw from
    `state.rng`. `teacher` (a frozen backbone on the device) adds
    `distill_weight * distill_loss(...)` and the metric `loss_kd`;
    `freeze_backbone` trains the head alone; `grad_accum` must be the
    MultiSteps K of the state's optimizer; `model_ema` > 0 needs
    `state.ema`. A trunk that draws dropout masks (`takes_rng`) gets the
    state's generator in its train-mode forwards (`rng=`): the dropout and
    stochastic depth of mobilenet_v2 and efficientnet_b0 draw their masks
    from it, as the JAX step gives those two trunks its dropout key. Runs
    on the card unless device='cpu' is passed. `mesh` makes it a rank's
    step of a multi-process run (module docstring).
    """
    device = resolve_device(device)
    if use_fused_head and not fused_supported(head_cfg.name):
        raise ValueError(f"head '{head_cfg.name}' has no fused-kernel path")
    k = max(1, int(grad_accum))
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

    def backbone(state, images, view=False):
        """The trunk's fp32 embeddings: in train mode (a second view moves
        no BatchNorm statistics; gradients flow through both, as in the JAX
        step), or frozen in eval mode with no backward."""
        if freeze_backbone:
            state.backbone.eval()
            with torch.no_grad():
                return state.backbone(images).to(torch.float32)
        state.backbone.train()
        kw = ({"rng": state.rng}
              if getattr(state.backbone, "takes_rng", False) else {})
        if view:
            with running_stats_frozen(state.backbone):
                return state.backbone(images, **kw).to(torch.float32)
        return state.backbone(images, **kw).to(torch.float32)

    def train_step(state: TrainState, images, labels, minput_images=None):
        if mesh is None:
            return one_step(state, images, labels, minput_images)
        with coll.using(mesh):
            state, metrics = one_step(state, images, labels, minput_images)
            return state, coll.average_metrics(metrics, mesh)

    def one_step(state: TrainState, images, labels, minput_images=None):
        images = apply_augmentations(state.rng, prepare(images),
                                     horizontal_flip, crop_pad, color_jitter,
                                     random_erasing)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        t_feats = None
        if teacher is not None:
            teacher.eval()
            with torch.no_grad():
                t_feats = teacher(images).to(torch.float32)
        feats = backbone(state, images)
        minput_feats = None
        if minput_images is not None:
            minput_feats = backbone(state, prepare(minput_images), view=True)
        rng = state.rng if head.requires_rng else None
        if use_fused_head:
            out = fused_apply(head_cfg, state.kernel_w, feats, labels,
                              state.head_state, rng=rng, minput=minput_feats,
                              mesh=mesh)
            loss_id, acc1, acc5 = out.loss_id, out.acc1, out.acc5
        else:
            out, loss_id, acc1, acc5 = eager_apply(
                head, head_cfg, state.kernel_w, feats, labels,
                state.head_state, rng, minput_feats, mesh)
        loss_mag = lambda_g * out.loss_g
        loss = loss_id + loss_mag
        if t_feats is not None:
            loss_kd = distill_weight * distill_loss(feats, t_feats,
                                                    distill_mode)
            loss = loss + loss_kd
        # the lr of the count before this update, as optax's schedule reads
        if lr_schedule is None:
            lr = torch.full((), state.optimizer.param_groups[0]["lr"],
                            dtype=torch.float32, device=device)
            lr_update = lr
        else:
            lr = lr_schedule(state.count)
            # MultiSteps' inner schedule counts updates: lr_inner(c * K)
            lr_update = (lr if k == 1 else
                         lr_schedule(torch.div(state.count, k,
                                               rounding_mode="floor") * k))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        coll.average_gradients(state.params(), mesh)
        if coll.model_size(mesh) > 1:
            # the kernel is split over the model group: a clipping norm
            # adds its shards' squares over the group
            state.optimizer.shard_norm([state.kernel_w], mesh.model_group)
        with torch.no_grad():
            state.lr.copy_(lr_update)
            state.optimizer.step(state.lr)
            if model_ema > 0.0:
                ema_update(state, model_ema, k)
            # after the backward, which may still read the old state
            copy_head_state(state.head_state, out.state)
            state.count.add_(1)
        state.step += 1
        metrics = {"loss": loss.detach(), "loss_id": loss_id.detach(),
                   "loss_mag": loss_mag.detach(), "acc1": acc1, "acc5": acc5,
                   "lr": lr, "feat_norm": out.norms.detach().mean()}
        if t_feats is not None:
            metrics["loss_kd"] = loss_kd.detach()
        return state, metrics

    return train_step


def ema_update(state: TrainState, decay: float, k: int) -> None:
    """ema = ema * d + p * (1 - d), written as the JAX package writes it.
    Under grad_accum K, d is 1 (the EMA stays) except after the K-th
    micro-step, where the parameters moved; `state.count` is the count
    before this step."""
    params = state.params()
    if k == 1:
        d, one_minus = decay, 1.0 - decay
    else:
        d = torch.where((state.count + 1) % k == 0, decay, 1.0)
        one_minus = 1.0 - d
    torch._foreach_mul_(state.ema, d)
    torch._foreach_add_(state.ema, torch._foreach_mul(params, one_minus))


def copy_head_state(head_state, new_state) -> None:
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
