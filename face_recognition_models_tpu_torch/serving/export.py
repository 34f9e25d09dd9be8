"""Export of the embedding model for serving. Port of face_recognition_
models_tpu/serving/export.py, with a torch.export program where the JAX
package writes StableHLO.

A trained backbone is written as a self-contained artifact: the `FRTE`
magic, a little-endian u32 header length, a JSON header, then one
`torch.export.save` program per platform with the weights inside. Each
program takes uint8 NHWC [B, S, S, 3] (the normalisation is part of it)
and returns fp32 [B, D] embeddings; the batch dimension is symbolic up to
the header's `max_batch` (cuDNN's fp32 batch norm takes at most 65,535
rows), and the loaded `fn` runs a larger batch in slices of at most that
many rows and joins them, so an artifact serves every batch size, as the
JAX one does. A program exported on the card holds
the card's device in its constants, so an artifact carries one program for
each platform it was exported for and a load never moves a program to
another device. `load_embedder` needs torch and nothing of the port's
model code.
"""

from __future__ import annotations

import copy
import io
import json
import os
import struct
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from face_recognition_models_tpu_torch.utils.device import resolve_device

_MAGIC = b"FRTE"  # Face Recognition Tpu Embedder
_VERSION = 1
_FORMAT = "face_recognition_models_tpu_torch/embedder"
PLATFORMS = ("cuda", "cpu")
MAX_BATCH = 65535   # the largest batch an artifact's program takes


class EmbedderArtifact(NamedTuple):
    fn: Callable[[np.ndarray], np.ndarray]  # uint8 [B,S,S,3] -> f32 [B,D]
    image_size: int
    embed_dim: int
    meta: dict


class _Embedder(torch.nn.Module):
    """uint8 NHWC -> fp32 embeddings: the eval step's normalisation
    (train/step.make_eval_step), its constants as buffers, then the
    backbone."""

    def __init__(self, backbone: torch.nn.Module, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.backbone = backbone
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32) * self.scale + self.bias
        return self.backbone(x).to(torch.float32)


def _export_program(backbone, state_dict, device: torch.device,
                    image_size: int, mean, std,
                    max_batch: int = MAX_BATCH) -> bytes:
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.ops.image_ops import (
        normalization_constants)

    backbone = copy.deepcopy(backbone)
    backbone.load_state_dict(state_dict)
    module = _Embedder(to_device(backbone, device),
                       *normalization_constants(mean, std, device=device))
    module.eval()
    # torch specialises a dimension of size 1, so the example batch is 2;
    # cuDNN's fp32 batch norm takes at most 65,535 rows, and the export
    # refuses a range its graph does not hold for
    example = torch.zeros((2, image_size, image_size, 3), dtype=torch.uint8,
                          device=device)
    batch = torch.export.Dim("b", min=1, max=max_batch)
    with torch.no_grad():
        program = torch.export.export(
            module, (example,), dynamic_shapes={"images": {0: batch}})
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_embedder(backbone, state_dict, path: str, image_size: int = 112,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                    platforms: Optional[Sequence[str]] = None,
                    fold_bn: str = "never",
                    meta: Optional[dict] = None,
                    max_batch: int = MAX_BATCH) -> dict:
    """Export (backbone module, its state_dict) as a serving artifact at
    `path`; returns the header written.

    platforms: devices to export a program for, from 'cuda' and 'cpu';
    default the card (resolve_device). fold_bn: 'always' folds BatchNorm
    into the convs of a ResNet (models/folding.py) before export and
    leaves every other trunk unfolded (`bn_folded` false), as the JAX
    export does; 'never' (default) exports the model as trained. max_batch:
    the largest batch a program takes (at most MAX_BATCH); `fn` slices
    larger ones."""
    from face_recognition_models_tpu_torch.models.resnet import ResNet

    platforms = list(platforms or [resolve_device(None).type])
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms must be drawn from {list(PLATFORMS)} "
                         f"(got {platforms})")
    if fold_bn not in ("never", "always"):
        raise ValueError(f"fold_bn must be 'never' or 'always' "
                         f"(got {fold_bn!r})")
    folded = False
    if (fold_bn == "always" and isinstance(backbone, ResNet)
            and not backbone.folded):
        from face_recognition_models_tpu_torch.models.folding import (
            fold_resnet_bn)
        state_dict = fold_resnet_bn(state_dict)
        backbone = backbone.clone(folded=True)
        folded = True
    if not 2 <= max_batch <= MAX_BATCH:
        raise ValueError(f"max_batch must be in [2, {MAX_BATCH}] "
                         f"(got {max_batch})")
    blobs = [_export_program(backbone, state_dict, resolve_device(p),
                             image_size, mean, std, max_batch)
             for p in platforms]
    header = {
        "format": _FORMAT,
        "version": _VERSION,
        "image_size": image_size,
        "embed_dim": int(backbone.embed_dim),
        "max_batch": max_batch,
        "platforms": platforms,
        "program_bytes": [len(b) for b in blobs],
        "bn_folded": folded,
        **(meta or {}),
    }
    header_bytes = json.dumps(header).encode("utf-8")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        for blob in blobs:
            f.write(blob)
    return header


def load_embedder(path: str, device=None) -> EmbedderArtifact:
    """Load a serving artifact's program for `device` (default the card);
    the port's model code is not needed. Its `fn` takes host uint8 images
    and returns host fp32 embeddings. Raises ValueError for a file that is
    not an artifact and for a device the artifact has no program for. A
    batch over the program's `max_batch` runs in slices of that many
    rows."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path} is not an embedder artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        if header.get("format") != _FORMAT:
            raise ValueError(f"{path} holds no torch.export program "
                             f"(format {header.get('format')!r})")
        platforms = header["platforms"]
        if device.type not in platforms:
            raise ValueError(
                f"{path} has programs for {platforms}, none for "
                f"{device.type!r}; export it with --platforms "
                f"{device.type}")
        i = platforms.index(device.type)
        f.seek(sum(header["program_bytes"][:i]), os.SEEK_CUR)
        blob = f.read(header["program_bytes"][i])
    module = torch.export.load(io.BytesIO(blob)).module()
    rows = header.get("max_batch", MAX_BATCH)

    def fn(images: np.ndarray) -> np.ndarray:
        images = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        with torch.no_grad():
            out = [module(part.to(device))
                   for part in torch.split(images, rows)]
        return (out[0] if len(out) == 1 else torch.cat(out)).cpu().numpy()

    return EmbedderArtifact(fn=fn, image_size=header["image_size"],
                            embed_dim=header["embed_dim"], meta=header)
