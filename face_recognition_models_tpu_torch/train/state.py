"""Train state. Port of face_recognition_models_tpu/train/state.py.

One object holds what a step reads and changes: the backbone module (its
parameters and BatchNorm buffers), the head kernel `kernel_w` [D, C] in the
JAX layout, the head state, the optimizer and the global step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from face_recognition_models_tpu_torch.config import TrainConfig
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.optim import get_optimizer


@dataclasses.dataclass
class TrainState:
    backbone: nn.Module
    kernel_w: nn.Parameter       # [D, C], JAX layout
    optimizer: torch.optim.Optimizer
    head_state: Any = None
    step: int = 0


def create_train_state(cfg: TrainConfig, head_cfg, device: torch.device):
    """Initialise (backbone, head, TrainState) from cfg.seed on `device`."""
    gen = torch.Generator().manual_seed(cfg.seed)
    backbone = get_backbone(cfg.backbone, embed_dim=head_cfg.feature_dim,
                            dtype=getattr(torch, cfg.compute_dtype))
    init_weights(backbone, gen)
    backbone = backbone.to(device)
    if device.type == "cuda":
        # NHWC batches arrive as channels-last NCHW views; cuDNN's bf16
        # convolutions are fastest with weights in the same layout
        backbone = backbone.to(memory_format=torch.channels_last)
    head = get_head(cfg.head)
    kernel_w = nn.Parameter(head.init_kernel(head_cfg, gen, device))
    opt = cfg.optimizer
    optimizer = get_optimizer(opt.name, [*backbone.parameters(), kernel_w],
                              opt.learning_rate, momentum=opt.momentum,
                              weight_decay=opt.weight_decay,
                              nesterov=opt.nesterov)
    state = TrainState(backbone=backbone, kernel_w=kernel_w,
                       optimizer=optimizer,
                       head_state=head.init_state(head_cfg))
    return backbone, head, state
