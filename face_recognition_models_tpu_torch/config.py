"""Typed configuration of the port's training path.

The port's own copy of the fields of face_recognition_models_tpu/config.py
that the ResNet + ArcFace training path reads; defaults are the same values
(the reference's recipe: resnet18, ArcFace m=0.5 s=64, CASIA's 10,575
classes, batch 512, 112 px, SGD lr 0.1 momentum 0.9 wd 5e-4, customstep).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

FEATURE_DIM = 512
CASIA_NUM_CLASSES = 10575
IMAGE_SIZE = 112


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Base for all margin-head configs."""

    name: str = "base"
    feature_dim: int = FEATURE_DIM
    num_classes: int = CASIA_NUM_CLASSES


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig(HeadConfig):
    """Additive angular margin (reference criterion.py:232-301)."""

    name: str = "arcface"
    m: float = 0.5
    s: float = 64.0
    easy_margin: bool = False


HEAD_CONFIGS = {"arcface": ArcFaceConfig}


def make_head_config(name: str, **overrides) -> HeadConfig:
    key = name.lower()
    if key not in HEAD_CONFIGS:
        raise ValueError(
            f"Unknown head '{name}'. Available: {sorted(HEAD_CONFIGS)}")
    return HEAD_CONFIGS[key](**overrides)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    # CustomStepLR: multiply the lr by `ratio` at each epoch in `steps`.
    name: str = "customstep"
    steps: Tuple[int, ...] = (20, 40, 60)
    ratio: float = 0.1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: int = IMAGE_SIZE
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    backbone: str = "resnet18"
    head: str = "arcface"
    num_classes: int = CASIA_NUM_CLASSES
    batch_size: int = 512
    epochs: int = 30
    print_freq: int = 100
    # bf16 convolutions (autocast) with fp32 parameters, BatchNorm and head
    compute_dtype: str = "bfloat16"
    seed: int = 0
    # True: the fused margin + CE kernels; False: the eager [N, C] head
    use_fused_head: bool = True
    optimizer: OptimizerConfig = OptimizerConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    data: DataConfig = DataConfig()
