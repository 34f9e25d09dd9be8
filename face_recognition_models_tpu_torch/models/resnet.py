"""ResNet-18 / ResNet-50 embedding backbones in PyTorch.

Port of face_recognition_models_tpu/models/resnet.py: the torchvision v1.5
graph (stride on the 3x3 conv of bottlenecks) with the classifier replaced
by an `embed_dim` Dense layer. Input is NHWC at the public boundary, as in the
JAX package, and NCHW (channels-last in memory) inside. Parameter names
follow torchvision, the layout `utils/torch_export.export_resnet_state_dict`
writes, so `utils/weights.from_jax` carries JAX weights over one to one.

Numerics follow the flax model: convolutions and the Dense layer run in
`dtype` (bf16 under autocast on the training path); BatchNorm statistics and
affine math are fp32 with flax's momentum 0.9 / eps 1e-5, and the running
variance is updated with the *biased* batch variance (nn.BatchNorm2d would
use the unbiased one). `bn_dtype` is flax's `BatchNorm(dtype=...)`: the
statistics, normalize and affine math stay fp32 and the output is rounded
to `bn_dtype` (bf16: the residual adds then run in bf16 too). The stem is
the plain 7x7/2 conv: the JAX package's default space-to-depth stem is
numerically the same conv.

`folded=True` is the BatchNorm-folded inference model of the JAX package's
`ResNet(folded=True)`: every conv carries a bias, every BatchNorm (the
downsample's included) is the identity, and a train-mode forward raises.
Its weights come from `models/folding.fold_resnet_bn`.

`running_stats_frozen(model)` runs train-mode forwards (batch statistics)
that leave the running buffers as they are: the JAX train step runs QAFace's
degraded view in train mode and drops the statistics it mutates.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn


# the compute dtypes a trunk runs its convolutions and Dense layers in
# under autocast; fp32 and fp64 trunks run as they are
AUTOCAST_DTYPES = (torch.bfloat16, torch.float16)


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a normalisation's statistics: fp32, or fp64 for fp64
    input (flax promotes the statistics' dtype to at least fp32)."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=eps, dtype=dtype) over
    the channels of an NCHW map or the features of an [N, F] batch.

    The math is fp32; the output is `dtype` whatever the input dtype (fp32
    by default; a bf16 input with dtype bf16 goes through F.batch_norm's
    mixed-dtype path, which computes in fp32 and rounds once). In training
    mode it normalises with the batch statistics and, unless `update_stats`
    is False, moves the running averages as ra = 0.9 * ra + 0.1 *
    batch_stat, with the biased variance. `use_scale=False` is flax's
    BatchNorm(use_scale=False): `weight` is a buffer of ones that no update
    touches (arcface_torch's frozen `features.weight`)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 use_scale: bool = True):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        if use_scale:
            self.weight = nn.Parameter(torch.ones(num_features))
        else:
            self.register_buffer("weight", torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            x = x.to(torch.float32)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.dtype)
        if self.update_stats:
            with torch.no_grad():
                dims = (0,) if x.dim() == 2 else (0, 2, 3)
                var, mean = torch.var_mean(x.to(stats_dtype(x)), dim=dims,
                                           unbiased=False)
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(self.dtype)


@contextlib.contextmanager
def running_stats_frozen(model: nn.Module) -> Iterator[None]:
    """Inside the block, train-mode forwards of `model` normalise with batch
    statistics but move no running_mean / running_var / num_batches_tracked."""
    norms = [mod for mod in model.modules() if isinstance(mod, BatchNorm)]
    for mod in norms:
        mod.update_stats = False
    try:
        yield
    finally:
        for mod in norms:
            mod.update_stats = True


class Conv2d(nn.Conv2d):
    """nn.Conv2d with one CPU repair. oneDNN's bf16 backward of a padded,
    strided k x k conv over a 1 x 1 input reads memory it never wrote, so
    its gradients turn NaN where that memory held NaN (a ResNet's last
    stage at 16 px). Over a 1 x 1 input every tap but the centre one meets
    the zero padding: the conv is the centre tap's 1 x 1 product, and runs
    as that."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        if (x.device.type == "cpu" and k > 1 and self.stride[0] > 1
                and x.shape[-2:] == (1, 1)):
            c = k // 2
            return F.conv2d(x, self.weight[:, :, c:c + 1, c:c + 1],
                            self.bias, groups=self.groups)
        return super().forward(x)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          folded: bool = False) -> nn.Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=folded)


def _norm(num_features: int, dtype: torch.dtype, folded: bool) -> nn.Module:
    return nn.Identity() if folded else BatchNorm(num_features, dtype=dtype)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32,
                 folded: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(cin, filters, 3, stride, folded)
        self.bn1 = _norm(filters, bn_dtype, folded)
        self.conv2 = _conv(filters, filters, 3, folded=folded)
        self.bn2 = _norm(filters, bn_dtype, folded)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                _conv(cin, filters, 1, stride, folded),
                _norm(filters, bn_dtype, folded))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y.to(self.dtype)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual).to(self.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck (ResNet-50; torchvision v1.5)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32,
                 folded: bool = False):
        super().__init__()
        self.dtype = dtype
        cout = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1, folded=folded)
        self.bn1 = _norm(filters, bn_dtype, folded)
        self.conv2 = _conv(filters, filters, 3, stride, folded)
        self.bn2 = _norm(filters, bn_dtype, folded)
        self.conv3 = _conv(filters, cout, 1, folded=folded)
        self.bn3 = _norm(cout, bn_dtype, folded)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _conv(cin, cout, 1, stride, folded),
                _norm(cout, bn_dtype, folded))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y.to(self.dtype))))
        y = self.bn3(self.conv3(y.to(self.dtype)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual).to(self.dtype)


class ResNet(nn.Module):
    """ResNet trunk -> global average pool -> Dense(embed_dim).

    forward takes NHWC images [N, H, W, 3] and returns [N, embed_dim]
    embeddings in `dtype`. `bn_dtype` is every BatchNorm's output dtype;
    `folded` builds the BatchNorm-folded inference model (module
    docstring). `clone(**changes)` builds the same ResNet with some
    arguments changed."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: Type[nn.Module], embed_dim: int = 512,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32, folded: bool = False):
        super().__init__()
        self._args = dict(stage_sizes=stage_sizes, block=block,
                          embed_dim=embed_dim, num_filters=num_filters,
                          dtype=dtype, bn_dtype=bn_dtype, folded=folded)
        self.dtype, self.folded, self.embed_dim = dtype, folded, embed_dim
        self.conv1 = nn.Conv2d(3, num_filters, 7, stride=2, padding=3,
                               bias=folded)
        self.bn1 = _norm(num_filters, bn_dtype, folded)
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, num_filters * 2 ** i, stride, dtype,
                                    bn_dtype, folded))
                cin = num_filters * 2 ** i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(cin, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        if self.folded and self.training:
            raise ValueError("BN-folded models are inference-only")
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = self.conv1(x.to(self.dtype))
            x = F.relu(self.bn1(x)).to(self.dtype)
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for i in range(self.num_stages):
                x = getattr(self, f"layer{i + 1}")(x)
            return self.fc(x.mean(dim=(2, 3)))

    def clone(self, **changes) -> "ResNet":
        """A new ResNet of this one's arguments with `changes` (fresh
        weights), as flax's Module.clone."""
        return ResNet(**{**self._args, **changes})


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]):
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise like the flax model: lecun-normal convs and Dense
    kernels, zero biases, unit BatchNorm / LayerNorm scale and zero shift
    (their construction values), and each module's own flax initialiser
    where it has one (`reset_flax_(generator)`: PReLU's 0.25, ViT's
    position embedding), all drawn from `generator`."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            reset = getattr(mod, "reset_flax_", None)
            if reset is not None:
                reset(generator)


def resnet18(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
             bn_dtype: torch.dtype = torch.float32,
             image_size: int = 112) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, embed_dim=embed_dim, dtype=dtype,
                  bn_dtype=bn_dtype)


def resnet50(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
             bn_dtype: torch.dtype = torch.float32,
             image_size: int = 112) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, embed_dim=embed_dim, dtype=dtype,
                  bn_dtype=bn_dtype)
