"""On-device image preprocessing.

Port of face_recognition_models_tpu/ops/image_ops.py: batches cross to the
card as uint8 NHWC and are normalised there with one multiply-add, x *
scale + bias, whose constants the train and eval steps make once
(`normalization_constants`); and the train-time augmentations of the
normalised batch, `apply_augmentations`: flip -> shift-crop (reflect) ->
brightness / contrast jitter -> random erasing, each a no-op at its
default. Plus `degrade_images` of face_recognition_models_tpu/train/
loop.py, QAFace's degraded view of a batch, made on its device.

Each augmentation is a draw and an apply. The draw takes a torch.Generator
on the batch's device (the train state's step generator, which a CUDA graph
of train steps registers) and returns the per-image parameters; the apply
takes them explicitly and computes what the JAX function computes from its
own draws. So the applies are held to the JAX functions on the same
parameters, and the draws to the JAX distributions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from face_recognition_models_tpu_torch.parallel import collectives as coll


def normalization_constants(mean: Sequence[float] = (0.5, 0.5, 0.5),
                            std: Sequence[float] = (0.5, 0.5, 0.5),
                            dtype: torch.dtype = torch.float32,
                            device=None):
    """(scale, bias) [3] on `device` with ((x / 255) - mean) / std =
    x * scale + bias. A caller that makes them once copies nothing from
    the host per batch (a CUDA graph can hold the normalisation)."""
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    scale = (1.0 / (255.0 * std)).to(dtype=dtype, device=device)
    bias = (-mean / std).to(dtype=dtype, device=device)
    return scale, bias


def degrade_images(images: torch.Tensor) -> torch.Tensor:
    """Quality-degraded view for QAFace's `minput`: a 2x down / up bilinear
    resample of NHWC images on their device, antialiased as
    jax.image.resize is.

    Keeps the input dtype: a uint8 batch comes back uint8 (rounded, in
    [0, 255]) so the step normalises both views alike; a float batch stays
    float.
    """
    _, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    small = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                          align_corners=False, antialias=True)
    out = F.interpolate(small, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    if images.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return out


# random erasing's relative area and log aspect ratio ranges (Zhong et al.
# 2020; the JAX package's random_erasing defaults)
ERASE_AREA = (0.02, 0.2)
ERASE_LOG_ASPECT = (-1.204, 1.204)


def _uniform(gen: torch.Generator, n: int, low: float, high: float,
             device) -> torch.Tensor:
    """n float32 draws of U(low, high), as low + (high - low) * u."""
    u = torch.rand(n, generator=gen, device=device)
    return low + (high - low) * u


def draw_flip(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """[n] bool: flip image i (probability 0.5)."""
    return torch.rand(n, generator=gen, device=device) < 0.5


def apply_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """random_horizontal_flip of NHWC `images` with the mask `flip`."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def draw_shift(gen: torch.Generator, n: int, pad: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([n] dy, [n] dx) int64 offsets, each uniform in [-pad, pad]."""
    dy = torch.randint(-pad, pad + 1, (n,), generator=gen, device=device)
    dx = torch.randint(-pad, pad + 1, (n,), generator=gen, device=device)
    return dy, dx


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """np.pad(mode='reflect') index map for idx in (-size, 2 * size - 1)."""
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= size, 2 * size - 2 - idx, idx)


def apply_shift(images: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor
                ) -> torch.Tensor:
    """random_shift_crop with the offsets (dy, dx): reflect-pad and crop
    back at the offset, as two gathers over reflect-mapped rows and
    columns."""
    n, h, w, c = images.shape
    rows = _reflect_index(torch.arange(h, device=images.device)[None, :]
                          + dy[:, None], h)                       # [N, H]
    cols = _reflect_index(torch.arange(w, device=images.device)[None, :]
                          + dx[:, None], w)                       # [N, W]
    out = torch.gather(images, 1,
                       rows[:, :, None, None].expand(n, h, w, c))
    return torch.gather(out, 2, cols[:, None, :, None].expand(n, h, w, c))


def draw_jitter(gen: torch.Generator, n: int, strength: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([n] brightness b ~ U(-s, s), [n] contrast c ~ U(1 - s, 1 + s))."""
    b = _uniform(gen, n, -strength, strength, device)
    c = _uniform(gen, n, 1.0 - strength, 1.0 + strength, device)
    return b, c


def apply_jitter(images: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                 ) -> torch.Tensor:
    """random_color_jitter: (x - mean) * c + mean + b, the mean over each
    image's H, W and C."""
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return ((images - mean) * c[:, None, None, None] + mean
            + b[:, None, None, None])


def draw_erasing(gen: torch.Generator, n: int, h: int, w: int, p: float,
                 device):
    """(y0, x0, eh, ew, live) of random erasing, each [n]: a box of area
    U(ERASE_AREA) * h * w and aspect exp(U(ERASE_LOG_ASPECT)), its sides
    clip(round(...), 1, side) (round half to even, as jnp.round), its
    corner int(u * (side - box + 1)), erased where `live` (probability
    p)."""
    area = _uniform(gen, n, *ERASE_AREA, device) * (h * w)
    aspect = torch.exp(_uniform(gen, n, *ERASE_LOG_ASPECT, device))
    eh = torch.clip(torch.round(torch.sqrt(area * aspect)), 1, h)
    ew = torch.clip(torch.round(torch.sqrt(area / aspect)), 1, w)
    y0 = (torch.rand(n, generator=gen, device=device)
          * (h - eh + 1)).to(torch.int32)
    x0 = (torch.rand(n, generator=gen, device=device)
          * (w - ew + 1)).to(torch.int32)
    live = torch.rand(n, generator=gen, device=device) < p
    return y0, x0, eh, ew, live


def apply_erasing(images: torch.Tensor, y0, x0, eh, ew, live
                  ) -> torch.Tensor:
    """random_erasing: zero (the normalised mean) inside each live box."""
    _, h, w, _ = images.shape
    rows = torch.arange(h, device=images.device)[None, :, None]
    cols = torch.arange(w, device=images.device)[None, None, :]
    y1 = (y0 + eh.to(torch.int32))[:, None, None]
    x1 = (x0 + ew.to(torch.int32))[:, None, None]
    in_box = ((rows >= y0[:, None, None]) & (rows < y1)
              & (cols >= x0[:, None, None]) & (cols < x1))
    erase = (in_box & live[:, None, None])[..., None]
    return torch.where(erase, torch.zeros((), dtype=images.dtype,
                                          device=images.device), images)


def apply_augmentations(gen: Optional[torch.Generator], images: torch.Tensor,
                        horizontal_flip: bool = False, crop_pad: int = 0,
                        color_jitter: float = 0.0, erasing: float = 0.0
                        ) -> torch.Tensor:
    """The train-time chain on normalised NHWC float images, in the JAX
    order: flip -> shift-crop -> jitter -> erasing, with parameters drawn
    from `gen` on the card. A disabled op draws nothing, so the default
    recipe leaves the batch and the generator as they are. Under an active
    mesh the draws are the global batch's and each rank keeps its rows
    (parallel/collectives.py)."""
    n, h, w, _ = images.shape
    n_all, dev = coll.global_rows(n), images.device

    def rows(*draws):
        return tuple(coll.local_rows(d) for d in draws)

    if horizontal_flip:
        images = apply_flip(images, *rows(draw_flip(gen, n_all, dev)))
    if crop_pad > 0:
        images = apply_shift(images, *rows(*draw_shift(gen, n_all, crop_pad,
                                                       dev)))
    if color_jitter > 0.0:
        images = apply_jitter(images, *rows(*draw_jitter(
            gen, n_all, color_jitter, dev)))
    if erasing > 0.0:
        images = apply_erasing(images, *rows(*draw_erasing(
            gen, n_all, h, w, erasing, dev)))
    return images
