"""Reference-style model API. Port of face_recognition_models_tpu/api.py.

The reference exposes one `*Net(num_classes, backbone)` class per head
(criterion.py: SphereFaceNet, CosFaceNet, ArcFaceNet, MV_SoftmaxNet,
CurricularFaceNet, VPLArcFaceNet, AdaFaceNet, ElasticArcFaceNet,
ElasticCosFaceNet, MagFaceNet, QAFaceNet) whose train-mode forward returns
the head's outputs and whose eval-mode forward returns embeddings. Here a
`MarginModel` is an nn.Module holding the backbone and the head's [D, C]
kernel:

    model = ArcFaceNet(num_classes=10575, backbone="resnet50")
    head_state = model.init(torch.Generator().manual_seed(0))   # the card
    out, batch_stats = model.train_forward(images, labels, head_state)
    embeddings = model.embed(images)

The module holds what the JAX functions take as `variables` and `kernel`;
the head state is passed as in the JAX API.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads import HeadOutput, get_head
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.models.resnet import (
    init_weights,
    running_stats_frozen,
)
from face_recognition_models_tpu_torch.ops.image_ops import (
    normalization_constants,
)
from face_recognition_models_tpu_torch.utils.device import resolve_device


def _normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ((x / 255) - 0.5) / 0.5; float input as it is."""
    if images.dtype != torch.uint8:
        return images
    scale, bias = normalization_constants(device=images.device)
    return images.to(torch.float32) * scale + bias


class MarginModel(nn.Module):
    """Backbone + margin head bundle (the *Net equivalent). The backbone
    is built by get_backbone (bf16 convolutions, fp32 BatchNorm) for
    `image_size`; `kernel` is the head's [D, C] class prototypes."""

    def __init__(self, head_name: str, num_classes: int,
                 backbone_name: str = "resnet18",
                 image_size: int = cfg_lib.IMAGE_SIZE,
                 head_overrides: Optional[dict] = None):
        super().__init__()
        self.head_name = head_name
        self.num_classes = num_classes
        self.backbone_name = backbone_name
        self.image_size = image_size
        self.head_cfg = cfg_lib.make_head_config(
            head_name, num_classes=num_classes, **(head_overrides or {}))
        self.head = get_head(head_name)
        self.backbone = get_backbone(backbone_name,
                                     embed_dim=self.head_cfg.feature_dim,
                                     image_size=image_size)
        self.kernel = nn.Parameter(torch.zeros(self.head_cfg.feature_dim,
                                               num_classes))
        self.loss_model = head_name  # the reference's attribute

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Any:
        """Initialise the backbone and the kernel from `generator` (flax's
        initialisers, as train/state.create_train_state) and move the
        model to `device` (the card unless 'cpu' is asked for; the backbone
        placed as training and evaluation place it, models/backbones.
        to_device). Returns the head's initial state."""
        device = resolve_device(device)
        init_weights(self.backbone, generator)
        kernel = self.head.init_kernel(self.head_cfg, generator, "cpu")
        with torch.no_grad():
            self.kernel.copy_(kernel)
        self.to(device)
        to_device(self.backbone, device)
        return self.head.init_state(self.head_cfg, device)

    # ------------------------------------------------------------------
    def train_forward(self, images: torch.Tensor, labels: torch.Tensor,
                      head_state: Any = None,
                      rng: Optional[torch.Generator] = None,
                      minput_images: Optional[torch.Tensor] = None
                      ) -> Tuple[HeadOutput, Dict[str, torch.Tensor]]:
        """Training forward through the head's eager apply: (HeadOutput,
        the BatchNorm statistics after it). The reference's ([pre, logits],
        norms, loss_g, one_hot) with the new head state in out.state. The
        BatchNorm running statistics move in place, as in any train-mode
        forward; QAFace's degraded view (`minput_images`) moves none."""
        self.backbone.train()
        feats = self.backbone(_normalize(images)).to(torch.float32)
        minput_feats = None
        if minput_images is not None:
            with running_stats_frozen(self.backbone):
                minput_feats = self.backbone(
                    _normalize(minput_images)).to(torch.float32)
        out = self.head.apply(self.head_cfg, self.kernel, feats, labels,
                              head_state, rng=rng, minput=minput_feats)
        stats = {k: v.detach().clone()
                 for k, v in self.backbone.state_dict().items()
                 if "running_" in k}
        return out, stats

    # ------------------------------------------------------------------
    @torch.no_grad()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Eval forward: raw fp32 embeddings (the *Net eval branch)."""
        self.backbone.eval()
        return self.backbone(_normalize(images)).to(torch.float32)

    # ------------------------------------------------------------------
    def get_proxy(self, labels: torch.Tensor) -> torch.Tensor:
        """Raw class centres [D, N] of `labels` (criterion.py get_proxy)."""
        return self.kernel.index_select(1, labels.long())


def set_memory_training(head_state: Any, flag: bool) -> Any:
    """VPLArcFaceNet / QAFaceNet.change_training_mode: the head state with
    its memory-update flag set to `flag`."""
    if head_state is None or not hasattr(head_state, "training_flag"):
        raise ValueError("head state has no training flag "
                         "(only VPL-ArcFace and QAFace carry one)")
    old = head_state.training_flag
    return head_state._replace(training_flag=torch.tensor(
        bool(flag), dtype=old.dtype, device=old.device))


def _net(head_name):
    def ctor(num_classes: int, backbone: str = "resnet18", **overrides):
        return MarginModel(head_name=head_name, num_classes=num_classes,
                           backbone_name=backbone,
                           head_overrides=overrides or None)
    ctor.__name__ = head_name
    return ctor


SphereFaceNet = _net("sphereface")
CosFaceNet = _net("cosface")
ArcFaceNet = _net("arcface")
MV_SoftmaxNet = _net("mv_softmax")
CurricularFaceNet = _net("curricularface")
VPLArcFaceNet = _net("vpl_arcface")
AdaFaceNet = _net("adaface")
ElasticArcFaceNet = _net("elastic_arcface")
ElasticCosFaceNet = _net("elastic_cosface")
MagFaceNet = _net("magface")
QAFaceNet = _net("qaface")
