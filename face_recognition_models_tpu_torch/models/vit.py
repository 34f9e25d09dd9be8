"""Vision Transformer embedding backbones (vit_t / vit_s / vit_b). Port of
face_recognition_models_tpu/models/vit.py.

A patch-8 embedding (a 14 x 14 = 196-token sequence at 112 px) plus a
learned position embedding, pre-LN blocks with one fused qkv projection
[D, 3D], and the iresnet head convention: LayerNorm -> mean over tokens ->
Dense(embed) -> a feature BatchNorm with no scale, fp32 out. The parameter
names are the flax module names (`patch_embed`, `pos_embed`,
`block{i}.{ln1,attn.qkv,attn.proj,ln2,mlp_fc1,mlp_fc2}`, `ln_final`, `fc`,
`features`).

Numerics follow the flax model: the projections and the MLP in `dtype`;
the attention logits and softmax in fp32 (torch.matmul of the bf16 q and k
into fp32, as the einsum with preferred_element_type=float32), the
probabilities rounded to `dtype` before the product with v; GELU's tanh
form; LayerNorm (eps 1e-6) in fp32 with its output in `bn_dtype`.
`remat` recomputes each block's activations in the backward pass
(torch.utils.checkpoint, non-reentrant, no random state to keep, so it can
be captured in a CUDA graph); vit_b has it on by default, as in the JAX
package. The position embedding has one row per patch, so the model is
built for one `image_size` (a multiple of the patch size).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from face_recognition_models_tpu_torch.models.resnet import (
    AUTOCAST_DTYPES,
    BatchNorm,
    stats_dtype,
)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(epsilon=1e-6, dtype=dtype): fp32 math, the output
    in `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.to(stats_dtype(x)), self.normalized_shape,
                            self.weight, self.bias, self.eps).to(self.dtype)


class MHSA(nn.Module):
    """Multi-head self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, t, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(n, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]              # [N, h, T, dh]
        # fp32 logits (the einsum's preferred_element_type), scaled and
        # normalised in fp32, or in fp64 for an fp64 model as flax does
        acc = stats_dtype(q)
        with torch.autocast(x.device.type, enabled=False):
            logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
            logits = logits.float().to(acc) * (1.0 / math.sqrt(d // h))
            probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(v.dtype), v)       # [N, h, T, dh]
        return self.proj(out.transpose(1, 2).reshape(n, t, d))


class Block(nn.Module):
    """Pre-LN transformer block: x + MHSA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype, ln_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim, ln_dtype)
        self.attn = MHSA(dim, num_heads)
        self.ln2 = LayerNorm(dim, ln_dtype)
        self.mlp_fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_fc2 = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x).to(self.dtype))
        y = self.mlp_fc1(self.ln2(x).to(self.dtype))
        y = self.mlp_fc2(F.gelu(y, approximate="tanh"))
        return x + y


class VisionTransformer(nn.Module):
    """ViT trunk -> LN -> mean-pool -> Dense(embed) -> feature BN.
    forward takes NHWC images [N, S, S, 3] (S = image_size) and returns
    fp32 [N, embed_dim]."""

    def __init__(self, depth: int, dim: int, num_heads: int,
                 patch_size: int = 8, embed_dim: int = 512,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32, remat: bool = False,
                 image_size: int = 112):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} must be a multiple "
                             f"of patch_size={patch_size}")
        self.dtype, self.embed_dim, self.image_size = (dtype, embed_dim,
                                                       image_size)
        self.remat, self.depth = remat, depth
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        tokens = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads, mlp_ratio,
                                               dtype, bn_dtype))
        self.ln_final = LayerNorm(dim, bn_dtype)
        self.fc = nn.Linear(dim, embed_dim)
        self.features = BatchNorm(embed_dim, use_scale=False)

    def reset_flax_(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(f"this ViT is built for {self.image_size} px, "
                             f"got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = self.patch_embed(x.to(self.dtype))     # [N, D, gh, gw]
            x = x.flatten(2).transpose(1, 2)           # [N, T, D]
            x = x + self.pos_embed.to(self.dtype)
            for i in range(self.depth):
                block = getattr(self, f"block{i}")
                if self.remat and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = block(x)
            x = self.ln_final(x).float().mean(dim=1)
            x = self.fc(x.to(self.dtype))
        return self.features(x.to(torch.float32))


def vit_t(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
          bn_dtype: torch.dtype = torch.float32, remat: bool = False,
          image_size: int = 112) -> VisionTransformer:
    return VisionTransformer(depth=12, dim=192, num_heads=3,
                             embed_dim=embed_dim, dtype=dtype,
                             bn_dtype=bn_dtype, remat=remat,
                             image_size=image_size)


def vit_s(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
          bn_dtype: torch.dtype = torch.float32, remat: bool = False,
          image_size: int = 112) -> VisionTransformer:
    return VisionTransformer(depth=12, dim=384, num_heads=6,
                             embed_dim=embed_dim, dtype=dtype,
                             bn_dtype=bn_dtype, remat=remat,
                             image_size=image_size)


def vit_b(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
          bn_dtype: torch.dtype = torch.float32, remat: bool = True,
          image_size: int = 112) -> VisionTransformer:
    return VisionTransformer(depth=12, dim=768, num_heads=12,
                             embed_dim=embed_dim, dtype=dtype,
                             bn_dtype=bn_dtype, remat=remat,
                             image_size=image_size)
