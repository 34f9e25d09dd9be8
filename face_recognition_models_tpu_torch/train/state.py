"""Train state. Port of face_recognition_models_tpu/train/state.py.

One object holds what a step reads and changes: the backbone module (its
parameters and BatchNorm buffers), the head kernel `kernel_w` [D, C] in the
JAX layout, the head state, the optimizer (a rule of train/optim.py, or
train/accum.MultiSteps around one under grad_accum), the model EMA `ema`
(fp32 copies of the backbone's parameters and kernel_w, the JAX state's
`ema_params`, or None), Partial-FC's momentum of kernel_w `kernel_mom`
(its optimizer then holds the backbone alone; train/partial_fc.py), the
global step and the step generator `rng` (the JAX state's PRNG key: the
elastic heads and the augmentations draw from it).

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
from face_recognition_models_tpu_torch.parallel import sharding
from face_recognition_models_tpu_torch.train.accum import MultiSteps
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
    # model EMA of [*backbone.parameters(), kernel_w], or None
    ema: Optional[List[torch.Tensor]] = None
    # Partial-FC: the [D, C] momentum of kernel_w, which the step updates
    # on the sampled columns; None on the dense path
    kernel_mom: Optional[torch.Tensor] = None

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

    def params(self) -> List[torch.Tensor]:
        """The trained parameters, in the order of `ema`."""
        return [*self.backbone.parameters(), self.kernel_w]


def ema_state_dict(state: TrainState):
    """The EMA backbone in the backbone's state_dict layout: the EMA
    parameters with the live BatchNorm buffers (the JAX package's
    <model>_final_ema)."""
    sd = state.backbone.state_dict()
    for (name, _), e in zip(state.backbone.named_parameters(), state.ema):
        sd[name] = e
    return sd


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step changes in place: the backbone's
    parameters and buffers, kernel_w, the optimizer's tensors (slots, step
    counts, accumulated gradients), the head state, `count`, `lr`, the
    EMA and Partial-FC's kernel_mom."""
    return [*state.backbone.parameters(), *state.backbone.buffers(),
            state.kernel_w, *state.optimizer.tensors(),
            *(state.head_state or ()), state.count, state.lr,
            *(state.ema or ()),
            *(() if state.kernel_mom is None else (state.kernel_mom,))]


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


def build_backbone(cfg: TrainConfig, head_cfg) -> nn.Module:
    """The backbone module cfg trains, on the CPU, weights not set: the
    trunk of create_train_state, and the module an evaluation of its
    weights loads them into."""
    return get_backbone(cfg.backbone, embed_dim=head_cfg.feature_dim,
                        dtype=getattr(torch, cfg.compute_dtype),
                        bn_dtype=getattr(torch, cfg.bn_dtype),
                        image_size=cfg.data.image_size)


def create_train_state(cfg: TrainConfig, head_cfg, device: torch.device,
                       partial_fc: bool = False, mesh=None):
    """Initialise (backbone, head, TrainState) from cfg.seed on `device`;
    with cfg.pretrained_path the backbone then takes that state_dict, on
    the CPU, before it moves to `device`. The optimizer is cfg.optimizer's
    rule with the overrides the JAX package's `fit` passes (momentum,
    weight_decay, nesterov, clip_grad_norm), in MultiSteps for
    cfg.grad_accum > 1; with cfg.model_ema > 0 the EMA starts as a copy of
    the initial parameters. With `partial_fc` the optimizer holds the
    backbone alone and `kernel_mom` starts at zero (Partial-FC's manual
    update of kernel_w). With `mesh` every rank makes the whole state from
    the seed and keeps its class shard of the kernel and of the head
    memories (parallel/sharding.py); the optimizer, the EMA and kernel_mom
    follow the shard."""
    gen = torch.Generator().manual_seed(cfg.seed)
    backbone = build_backbone(cfg, head_cfg)
    init_weights(backbone, gen)
    if cfg.pretrained_path:
        load_pretrained_backbone(cfg.pretrained_path, cfg.backbone, backbone)
    backbone = to_device(backbone, device)
    head = get_head(cfg.head)
    kernel = head.init_kernel(head_cfg, gen, device)
    if mesh is not None and mesh.model > 1:
        kernel = sharding.shard(kernel, sharding.spec_for(
            "kernel_w", kernel.shape, head_cfg.num_classes), mesh)
    kernel_w = nn.Parameter(kernel)
    opt = cfg.optimizer
    trained = [*backbone.parameters()] + ([] if partial_fc else [kernel_w])
    optimizer = get_optimizer(opt.name, trained,
                              opt.learning_rate, momentum=opt.momentum,
                              weight_decay=opt.weight_decay,
                              nesterov=opt.nesterov,
                              clip_grad_norm=opt.clip_grad_norm)
    if cfg.grad_accum > 1:
        optimizer = MultiSteps(optimizer, cfg.grad_accum)
    state = TrainState(backbone=backbone, kernel_w=kernel_w,
                       optimizer=optimizer,
                       head_state=sharding.shard_head_state(
                           head.init_state(head_cfg, device),
                           head_cfg.num_classes, mesh),
                       rng=torch.Generator(device=device).manual_seed(
                           cfg.seed))
    if partial_fc:
        # imported here: train/partial_fc.py imports this module
        from face_recognition_models_tpu_torch.train.partial_fc import (
            init_partial_fc_opt_state)
        state.kernel_mom = init_partial_fc_opt_state(kernel_w)
    if cfg.model_ema > 0.0:
        state.ema = [p.detach().clone() for p in state.params()]
    return backbone, head, state
