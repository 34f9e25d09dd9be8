"""Batch embedding of an image tree to an .npz. Port of face_recognition_
models_tpu/serving/embed.py (`embed`).

The tree's images go through the port's `Loader` (PIL decode, thread pool)
into either a serving artifact (`export`'s `.frte`) or a checkpointed
backbone, and the L2-normalised embeddings land in an .npz: `embeddings`
[N, D] fp32, the relative `paths`, and per image the pre-normalisation
`norms` and `quality`.

Quality: for margin-trained backbones the pre-normalisation norm is a
learned quality signal. MagFace trains it to grow with face quality over
[l_a=10, u_a=110]; AdaFace uses the same norm as its quality proxy.
`norm_quality` maps it onto [0, 1], so 1:N identification can gate
low-quality images (`identify --min-quality`).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np


class _FlatIndex:
    """A Loader index over any image tree, in sorted order (no identity
    folders needed, no shuffle)."""

    def __init__(self, root: str):
        self.root = root
        rels = []
        for r, _dirs, files in os.walk(root):
            for f in files:
                if f.lower().endswith((".jpg", ".jpeg", ".png")):
                    rels.append(os.path.relpath(os.path.join(r, f), root))
        if not rels:
            raise FileNotFoundError(f"no images under {root}")
        self.rels = sorted(rels)

    def absolute_paths(self):
        return [os.path.join(self.root, r) for r in self.rels]

    def labels(self):
        return [0] * len(self.rels)

    def __len__(self):
        return len(self.rels)


def norm_quality(norms: np.ndarray, l_a: float = 10.0, u_a: float = 110.0
                 ) -> np.ndarray:
    """Pre-normalisation embedding norms mapped to a [0, 1] quality score:
    MagFace's norm range [l_a, u_a] mapped affinely, 0 at or below l_a, 1
    at or above u_a."""
    norms = np.asarray(norms, np.float32)
    return np.clip((norms - l_a) / (u_a - l_a), 0.0, 1.0)


def embed_directory(embed_fn: Callable, root: str, image_size: int,
                    batch_size: int = 256, num_workers: int = 8,
                    l2_normalize: bool = True
                    ) -> Tuple[np.ndarray, list, np.ndarray]:
    """Embed every image under `root` (any nesting). Returns (embeddings
    [N, D] fp32, relative paths, pre-normalisation norms [N]), in the
    order of the paths. `embed_fn(uint8 [B, S, S, 3])` returns host [B, D]
    embeddings.

    Row i must be path i's face, so a decode failure raises where the
    training loader would resample another image; the PIL backend is used
    for the same reason (the native decoder reads JPEG only). The last
    batch is padded by repeating the final image, and the padding rows are
    dropped."""
    from face_recognition_models_tpu_torch.data.pipeline import Loader

    index = _FlatIndex(root)
    n = len(index)
    pad = (-n) % batch_size
    if pad:
        index.rels = index.rels + index.rels[-1:] * pad
    loader = Loader(index, batch_size=batch_size, image_size=image_size,
                    shuffle=False, num_workers=num_workers,
                    drop_remainder=False, backend="pil")

    chunks = []
    for images, _labels in loader.epoch(0):
        if loader.skipped_images:
            raise ValueError(
                f"{loader.skipped_images} image(s) under {root} failed to "
                "decode; embeddings would be misattributed (the loader "
                "substitutes a random other image). Remove or fix the "
                "corrupt files and re-run.")
        chunks.append(np.asarray(embed_fn(images), np.float32))
    emb = np.concatenate(chunks, axis=0)[:n]
    paths = index.rels[:n]
    norms = np.linalg.norm(emb, axis=1)
    if l2_normalize:
        emb /= np.maximum(norms[:, None], 1e-12)
    return emb, list(paths), norms


def load_embed_fn(model_path: Optional[str], checkpoint_dir: Optional[str],
                  backbone: str, which: str, image_size: int,
                  bn_dtype: str = "bfloat16", embed_dim: int = 512,
                  device=None):
    """(embed_fn, image_size) from an `export` artifact or a training
    checkpoint dir (`embed` and `serve`); the artifact's image size wins.
    embed_fn takes host uint8 images and returns host fp32 embeddings,
    computed on `device` (the card unless 'cpu'). A checkpointed backbone
    runs with bf16 BatchNorm unless bn_dtype='float32' (training's
    numerics). Raises ValueError when neither source is given."""
    if model_path is not None:
        from face_recognition_models_tpu_torch.serving.export import (
            load_embedder)
        if bn_dtype != "bfloat16":
            print("WARNING: --bn-dtype has no effect on exported "
                  "artifacts (the BN compute dtype is baked in at "
                  "`export` time)")
        art = load_embedder(model_path, device=device)
        return art.fn, art.image_size
    if checkpoint_dir is None:
        raise ValueError("provide --model or --checkpoint-dir")

    import torch

    from face_recognition_models_tpu_torch.checkpoint import restore_backbone
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.train.step import make_eval_step
    from face_recognition_models_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model = get_backbone(backbone, embed_dim=embed_dim,
                         bn_dtype=getattr(torch, bn_dtype),
                         image_size=image_size)
    model.load_state_dict(restore_backbone(checkpoint_dir, which))
    eval_step = make_eval_step(to_device(model, device), device=device)
    return (lambda im: eval_step(im).cpu().numpy()), image_size


def run_embed_cli(input_dir: str, output: str,
                  model_path: Optional[str] = None,
                  checkpoint_dir: Optional[str] = None,
                  backbone: str = "resnet50", which: str = "final",
                  image_size: int = 112, batch_size: int = 256,
                  num_workers: int = 8, bn_dtype: str = "bfloat16",
                  embed_dim: int = 512, device=None) -> int:
    try:
        embed_fn, image_size = load_embed_fn(
            model_path, checkpoint_dir, backbone, which, image_size,
            bn_dtype, embed_dim=embed_dim, device=device)
    except ValueError as e:
        print(f"error: {e}")
        return 2

    emb, paths, norms = embed_directory(embed_fn, input_dir, image_size,
                                        batch_size, num_workers)
    quality = norm_quality(norms)
    np.savez(output, embeddings=emb, paths=np.asarray(paths),
             norms=norms, quality=quality)
    print(f"embedded {len(paths)} images -> {output} "
          f"({emb.shape[1]}-d, L2-normalized; "
          f"quality mean {quality.mean():.3f}, "
          f"min {quality.min():.3f} [MagFace norm map])")
    return 0
