"""Train state. Port of face_recognition_models_tpu/train/state.py.

One object holds what a step reads and changes: the backbone module (its
parameters and BatchNorm buffers), the head kernel `kernel_w` [D, C] in the
JAX layout, the head state, the optimizer, the global step and the step
generator `rng` (the JAX state's PRNG key: the elastic heads draw their
margins from it).

The global step is kept twice: `step`, a host int the loop reads for epochs
and checkpoints, and `count`, the same number as a 0-d int64 tensor on the
state's device, which the step's lr schedule reads. A step changes every
tensor of the state in place (`count` and `lr` too), so their addresses stay
those a CUDA graph of train steps was captured with.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

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
    # `step` on the device (int64), and the lr of the last update (fp32);
    # made on kernel_w's device when not given
    count: Optional[torch.Tensor] = None
    lr: Optional[torch.Tensor] = None

    def __post_init__(self):
        device = self.kernel_w.device
        if self.count is None:
            self.count = torch.full((), self.step, dtype=torch.int64,
                                    device=device)
        if self.lr is None:
            self.lr = torch.zeros((), dtype=torch.float32, device=device)

    def set_step(self, step: int) -> None:
        """Set the global step, on the host and on the device."""
        self.step = step
        self.count.fill_(step)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step changes in place: the backbone's
    parameters and buffers, kernel_w, the optimizer's slots, the head state,
    `count` and `lr`."""
    slots = [v for s in state.optimizer.state.values() for v in s.values()
             if isinstance(v, torch.Tensor)]
    return [*state.backbone.parameters(), *state.backbone.buffers(),
            state.kernel_w, *slots, *(state.head_state or ()), state.count,
            state.lr]


def snapshot(state: TrainState):
    """A copy of what a train step changes (state_tensors, the host step
    and the generator's state), for `restore`. The tensors are copied to
    host memory, so the copy takes no device memory."""
    return ([x.detach().to("cpu", copy=True) for x in state_tensors(state)],
            state.step, None if state.rng is None else state.rng.get_state())


@torch.no_grad()
def restore(state: TrainState, saved) -> None:
    """Write a `snapshot` back into the same state's tensors in place."""
    tensors, step, rng = saved
    for x, y in zip(state_tensors(state), tensors, strict=True):
        x.copy_(y)
    state.step = step
    if rng is not None:
        state.rng.set_state(rng)


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
