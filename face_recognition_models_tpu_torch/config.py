"""Typed configuration of the port's training path.

The port's own copy of the fields of face_recognition_models_tpu/config.py
that the ResNet training path reads, with every margin head of the JAX
package; defaults are the same values (the reference's recipe:
resnet18, ArcFace m=0.5 s=64, CASIA's 10,575 classes, batch 512, 112 px, SGD
lr 0.1 momentum 0.9 wd 5e-4, customstep, every lr schedule's fields), plus
the checkpoint and resume fields, step batching (`scan_steps`) and the
benchmarks `eval` reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

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
class SphereFaceConfig(HeadConfig):
    """A-Softmax with annealing (reference criterion.py:12-107)."""

    name: str = "sphereface"
    m: int = 2              # config.py:17 (the reference head's default is 4)
    base: float = 1000.0
    gamma: float = 0.12
    power: float = 1.0
    lambda_min: float = 5.0


@dataclasses.dataclass(frozen=True)
class CosFaceConfig(HeadConfig):
    """Additive cosine margin (reference criterion.py:137-197)."""

    name: str = "cosface"
    m: float = 0.35
    s: float = 64.0
    eps: float = 1e-4       # criterion.py:147


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig(HeadConfig):
    """Additive angular margin (reference criterion.py:232-301)."""

    name: str = "arcface"
    m: float = 0.5
    s: float = 64.0
    easy_margin: bool = False


@dataclasses.dataclass(frozen=True)
class MVSoftmaxConfig(HeadConfig):
    """Mis-classified vector guided softmax (reference
    criterion.py:327-461)."""

    name: str = "mv_softmax"
    m: float = 0.35
    mv_weight: float = 1.12
    s: float = 32.0
    margin_type: str = "am"  # 'am' or 'arc'
    eps: float = 1e-7       # criterion.py:413


@dataclasses.dataclass(frozen=True)
class CurricularFaceConfig(HeadConfig):
    """Curriculum hard-negative scaling with an EMA difficulty `t`
    (reference criterion.py:491-587)."""

    name: str = "curricularface"
    m: float = 0.5
    s: float = 64.0
    momentum: float = 0.01


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
class AdaFaceConfig(HeadConfig):
    """Norm-adaptive margin with an EMA of the batch's norm statistics
    (reference criterion.py:795-918). The reference weights the EMA toward
    the current batch (batch * t_alpha + (1 - t_alpha) * ema, :881-882);
    kept."""

    name: str = "adaface"
    m: float = 0.4
    h: float = 0.333
    s: float = 64.0
    t_alpha: float = 0.99
    eps: float = 1e-3       # criterion.py:828


@dataclasses.dataclass(frozen=True)
class ElasticArcFaceConfig(HeadConfig):
    """Per-sample Gaussian angular margin (reference
    criterion.py:1054-1154)."""

    name: str = "elastic_arcface"
    s: float = 64.0
    m: float = 0.5
    std: float = 0.0125
    plus: bool = False
    eps: float = 1e-7       # criterion.py:1104


@dataclasses.dataclass(frozen=True)
class ElasticCosFaceConfig(HeadConfig):
    """Per-sample Gaussian cosine margin (reference criterion.py:951-1030)."""

    name: str = "elastic_cosface"
    s: float = 64.0
    m: float = 0.35
    std: float = 0.0125
    plus: bool = False
    eps: float = 1e-7       # criterion.py:994


@dataclasses.dataclass(frozen=True)
class MagFaceConfig(HeadConfig):
    """Magnitude-adaptive margin plus the magnitude regulariser `loss_g`
    (reference criterion.py:1178-1301); the step adds lambda_g * loss_g."""

    name: str = "magface"
    s: float = 64.0
    easy_margin: bool = False
    l_margin: float = 0.45
    u_margin: float = 0.8
    l_a: float = 10.0
    u_a: float = 110.0
    eps: float = 1e-7       # criterion.py:1260


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


@dataclasses.dataclass(frozen=True)
class CombinedMarginConfig(HeadConfig):
    """Unified target margin cos(m1 * theta + m2) - m3 (insightface's
    combined-margin recipe): (1, 0.5, 0) is ArcFace, (1, 0, 0.35) CosFace."""

    name: str = "combined_margin"
    m1: float = 1.0
    m2: float = 0.5
    m3: float = 0.0
    s: float = 64.0
    eps: float = 1e-7


@dataclasses.dataclass(frozen=True)
class SubCenterArcFaceConfig(HeadConfig):
    """Sub-center ArcFace (Deng et al., ECCV 2020): k prototype columns per
    class, the cosine max-pooled over them before the ArcFace margin."""

    name: str = "subcenter_arcface"
    m: float = 0.5
    s: float = 64.0
    k: int = 3
    easy_margin: bool = False


@dataclasses.dataclass(frozen=True)
class AdaCosConfig(HeadConfig):
    """AdaCos (Zhang et al., CVPR 2019): no margin; the cosine scale is set
    from the batch (dynamic) or fixed at sqrt(2) * ln(C - 1), and kept as
    head state."""

    name: str = "adacos"
    dynamic: bool = True
    theta_clip: float = math.pi / 4.0


HEAD_CONFIGS = {
    "sphereface": SphereFaceConfig,
    "cosface": CosFaceConfig,
    "arcface": ArcFaceConfig,
    "mv_softmax": MVSoftmaxConfig,
    "curricularface": CurricularFaceConfig,
    "vpl_arcface": VPLArcFaceConfig,
    "adaface": AdaFaceConfig,
    "elastic_arcface": ElasticArcFaceConfig,
    "elastic_cosface": ElasticCosFaceConfig,
    "magface": MagFaceConfig,
    "qaface": QAFaceConfig,
    "combined_margin": CombinedMarginConfig,
    "subcenter_arcface": SubCenterArcFaceConfig,
    "adacos": AdaCosConfig,
}


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
    # adam-family knobs (fit passes only momentum, weight_decay, nesterov
    # and clip_grad_norm to the factory, as the JAX package's fit does)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # global-norm clipping of the raw gradients before the update rule
    # (optax.clip_by_global_norm); 0 = off
    clip_grad_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    # a name of train/schedules.SCHEDULES or a numeric id of SCHEDULER_DICT
    name: Union[str, int] = "customstep"
    # CustomStepLR: multiply the lr by `ratio` at each epoch in `steps`.
    steps: Tuple[int, ...] = (20, 40, 60)
    ratio: float = 0.1
    # step / multistep / cosine / exponential / warmup_cosine knobs
    step_size: int = 30
    gamma: float = 0.1
    milestones: Tuple[int, ...] = (40, 80, 100, 150)
    eta_min: float = 0.0
    warmup_epochs: int = 5


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Embedding-space distillation from a frozen trained teacher: the
    teacher runs in eval mode on the same normalised, augmented batch as
    the student, and `weight * distill_loss(student, teacher, mode)` joins
    the loss (mode "cosine": mean(1 - cos) of the L2-normalised embeddings;
    "mse": the mean squared L2 distance of the raw ones)."""

    backbone: str = "resnet50"   # the teacher's trunk
    checkpoint_dir: str = ""     # a previous `train` run's checkpoint dir
    which: str = "final"         # final | final_ema | min_loss | best_acc
    weight: float = 0.0          # 0 = off
    mode: str = "cosine"         # cosine | mse


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: int = IMAGE_SIZE
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # on-card augmentations of the normalised batch (ops/image_ops.py
    # apply_augmentations), each a no-op at its default
    horizontal_flip: bool = False
    crop_pad: int = 0            # random shift-crop, reflect padding px
    color_jitter: float = 0.0    # brightness / contrast jitter strength
    random_erasing: float = 0.0  # per-sample erasing probability


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    backbone: str = "resnet18"
    head: str = "arcface"
    num_classes: int = CASIA_NUM_CLASSES
    batch_size: int = 512
    epochs: int = 30
    # weight of the head's auxiliary loss (MagFace's magnitude regulariser)
    lambda_g: float = 0.0
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
    # a torchvision-layout backbone state_dict (.pth) to start from: the
    # reference trains from ImageNet-pretrained torchvision weights
    pretrained_path: Optional[str] = None
    keep_checkpoints: int = 3      # rotation keep-3 (model_utils.py:72-78)
    # True: the fused margin + CE kernels; False: the eager [N, C] head
    use_fused_head: bool = True
    # step batching: K train steps per replay of one CUDA graph (a plain
    # loop of the same K steps on the CPU); 1 = one step at a time
    scan_steps: int = 1
    # exponential moving average of the backbone parameters and kernel_w,
    # ema = ema * d + p * (1 - d) after every optimizer update; saved as
    # <model>_final_ema. 0 = off
    model_ema: float = 0.0
    # average the gradients of K micro-batches and update once every K
    # steps (optax.MultiSteps); BatchNorm statistics and the head state move
    # on every micro-batch. 1 = off
    grad_accum: int = 1
    # train the head alone: the backbone runs in eval mode without a
    # backward, and its parameters and optimizer slots stay as they are
    freeze_backbone: bool = False
    optimizer: OptimizerConfig = OptimizerConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    data: DataConfig = DataConfig()
    distill: DistillConfig = DistillConfig()
