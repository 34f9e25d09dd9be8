"""Typed configuration of the port's training path.

The port's own copy of the fields of face_recognition_models_tpu/config.py
that the ResNet training path reads, with the ArcFace, VPL-ArcFace and
QAFace heads; defaults are the same values (the reference's recipe:
resnet18, ArcFace m=0.5 s=64, CASIA's 10,575 classes, batch 512, 112 px, SGD
lr 0.1 momentum 0.9 wd 5e-4, customstep), plus the checkpoint and resume
fields and the benchmarks `eval` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FEATURE_DIM = 512
CASIA_NUM_CLASSES = 10575
IMAGE_SIZE = 112
# the verification benchmarks of `eval` (evaluate_models.py's five)
EVAL_BENCHMARKS = ("agedb_30", "cfp_fp", "lfw", "calfw", "cplfw")


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


@dataclasses.dataclass(frozen=True)
class VPLArcFaceConfig(HeadConfig):
    """ArcFace over a virtual-prototype memory blend (reference
    criterion.py:619-762)."""

    name: str = "vpl_arcface"
    s: float = 64.0
    m: float = 0.5
    easy_margin: bool = False
    lamda: float = 0.15
    delta: int = 100
    eps: float = 1e-7


@dataclasses.dataclass(frozen=True)
class QAFaceConfig(HeadConfig):
    """Quality-aware head with an injection memory (reference
    criterion.py:1331-1520). The training pipeline passes a degraded view of
    the batch as `minput`. On short runs the memory replacement stalls
    verification; `--head-arg delta=1` keeps the memory from activating."""

    name: str = "qaface"
    s: float = 64.0
    m: float = 0.5
    easy_margin: bool = False
    delta: int = 1000
    tto: float = 2.0
    alpha: float = 0.99
    eps: float = 1e-7


HEAD_CONFIGS = {"arcface": ArcFaceConfig, "vpl_arcface": VPLArcFaceConfig,
                "qaface": QAFaceConfig}


def make_head_config(name: str, **overrides) -> HeadConfig:
    key = name.lower()
    if key not in HEAD_CONFIGS:
        raise ValueError(
            f"Unknown head '{name}'. Available: {sorted(HEAD_CONFIGS)}")
    return HEAD_CONFIGS[key](**overrides)


def parse_head_overrides(name: str, items) -> dict:
    """Parse CLI 'key=value' strings into typed head-config overrides.

    Values are coerced to the type of the field's default, so
    `--head-arg delta=1` round-trips into the frozen dataclass. Unknown keys
    raise with the head's editable fields.
    """
    key = name.lower()
    if key not in HEAD_CONFIGS:
        raise ValueError(
            f"Unknown head '{name}'. Available: {sorted(HEAD_CONFIGS)}")
    defaults = HEAD_CONFIGS[key]()
    # name is fixed; num_classes comes from the run's own settings
    editable = {f.name for f in dataclasses.fields(defaults)
                if f.name not in ("name", "num_classes")}
    out = {}
    for item in items:
        k, sep, v = item.partition("=")
        if not sep or k not in editable:
            raise ValueError(
                f"--head-arg '{item}': expected key=value with key in "
                f"{sorted(editable)}")
        default = getattr(defaults, k)
        if isinstance(default, bool):
            out[k] = v.lower() in ("1", "true", "yes", "on")
        else:
            out[k] = type(default)(v)
    return out


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
    # BatchNorm output dtype: statistics, normalize and affine math run in
    # fp32 either way (flax BatchNorm(dtype=...)); "bfloat16" rounds the
    # output, as the embedding benchmark runs it
    bn_dtype: str = "float32"
    seed: int = 0
    working_path: str = ""
    continue_train: Optional[str] = None  # None | 'latest' | 'min_loss'
    keep_checkpoints: int = 3      # rotation keep-3 (model_utils.py:72-78)
    # True: the fused margin + CE kernels; False: the eager [N, C] head
    use_fused_head: bool = True
    optimizer: OptimizerConfig = OptimizerConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    data: DataConfig = DataConfig()
