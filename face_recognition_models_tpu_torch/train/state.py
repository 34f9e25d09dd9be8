"""Train state. Port of face_recognition_models_tpu/train/state.py.

One object holds what a step reads and changes: the backbone module (its
parameters and BatchNorm buffers), the head kernel `kernel_w` [D, C] in the
JAX layout, the head state, the optimizer, the global step and the step
generator `rng` (the JAX state's PRNG key: the elastic heads draw their
margins from it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from face_recognition_models_tpu_torch.config import TrainConfig
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.utils.pretrained import (
    load_pretrained_backbone,
)


@dataclasses.dataclass
class TrainState:
    backbone: nn.Module
    kernel_w: nn.Parameter       # [D, C], JAX layout
    optimizer: torch.optim.Optimizer
    head_state: Any = None
    step: int = 0
    # torch.Generator on the state's device, seeded from cfg.seed by
    # create_train_state; the elastic heads draw their margins from it
    rng: Optional[torch.Generator] = None


def create_train_state(cfg: TrainConfig, head_cfg, device: torch.device):
    """Initialise (backbone, head, TrainState) from cfg.seed on `device`;
    with cfg.pretrained_path the backbone then takes that state_dict, on
    the CPU, before it moves to `device`."""
    gen = torch.Generator().manual_seed(cfg.seed)
    backbone = get_backbone(cfg.backbone, embed_dim=head_cfg.feature_dim,
                            dtype=getattr(torch, cfg.compute_dtype),
                            bn_dtype=getattr(torch, cfg.bn_dtype))
    init_weights(backbone, gen)
    if cfg.pretrained_path:
        load_pretrained_backbone(cfg.pretrained_path, cfg.backbone, backbone)
    backbone = to_device(backbone, device)
    head = get_head(cfg.head)
    kernel_w = nn.Parameter(head.init_kernel(head_cfg, gen, device))
    opt = cfg.optimizer
    optimizer = get_optimizer(opt.name, [*backbone.parameters(), kernel_w],
                              opt.learning_rate, momentum=opt.momentum,
                              weight_decay=opt.weight_decay,
                              nesterov=opt.nesterov)
    state = TrainState(backbone=backbone, kernel_w=kernel_w,
                       optimizer=optimizer,
                       head_state=head.init_state(head_cfg, device),
                       rng=torch.Generator(device=device).manual_seed(
                           cfg.seed))
    return backbone, head, state
