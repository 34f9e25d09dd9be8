"""Backbone initialisation from a torch state_dict on disk (`train
--pretrained`). Port of `load_pretrained_backbone` of
face_recognition_models_tpu/utils/torch_port.py.

The reference trains from ImageNet-pretrained torchvision weights
(backbones.py:12-26); the JAX package also reads insightface's
arcface_torch iresnets. The port's trunks for those files use their
parameter names as they are (torchvision's resnet18 / resnet50 /
mobilenet_v2 / efficientnet_b0, arcface_torch's iresnet18 / 50 / 100), so
a file loads key for key. A classifier (`fc`, or `classifier.1` of
mobilenet_v2 and efficientnet_b0) that does not fit the embedding layer is
left out, as the JAX loader leaves it out; one of the embedding's shape is
loaded. An iresnet's `fc` is its embedding layer: a shape that does not
fit raises (the model was built for another image size), and its frozen
`features.weight` must be 1 (the model has no scale there) and is not
read. Any other missing or unexpected key raises. A file without
`num_batches_tracked` counters (older torchvision files) keeps the
model's own.
"""

from __future__ import annotations

import torch
from torch import nn

# the JAX package's `_PORTERS` (utils/torch_port.py)
PORTED = ("resnet18", "resnet50", "efficientnet_b0", "mobilenet_v2",
          "iresnet18", "iresnet50", "iresnet100")
_CLASSIFIER = {"efficientnet_b0": "classifier.1",
               "mobilenet_v2": "classifier.1"}


def load_pretrained_backbone(path: str, backbone_name: str,
                             backbone: nn.Module) -> None:
    """Load the torch state_dict file `path` into `backbone` (a
    `backbone_name` trunk, on any device) in place. The file is read on the
    CPU; a bare state_dict or one wrapped under 'state_dict' or 'model'."""
    name = backbone_name.lower()
    if name not in PORTED:
        raise ValueError(f"--pretrained supports {sorted(PORTED)}; got "
                         f"'{backbone_name}'")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and wrapper in sd and not hasattr(
                sd[wrapper], "shape"):
            sd = sd[wrapper]
    own = backbone.state_dict()
    sd = dict(sd)
    iresnet = name.startswith("iresnet")
    head = _CLASSIFIER.get(name, "fc")
    fc = (head + ".weight", head + ".bias")
    if (not iresnet and fc[0] in sd
            and sd[fc[0]].shape != own[fc[0]].shape):
        sd.pop(fc[0])
        sd.pop(fc[1], None)
    if iresnet and "features.weight" in sd:
        w = sd.pop("features.weight").float()
        if not torch.allclose(w, torch.ones_like(w), atol=1e-3):
            raise ValueError(
                f"{path}: the features BatchNorm1d scale is not frozen at 1 "
                f"(max deviation {float((w - 1).abs().max()):.3e}); the "
                "iresnet has no scale there and cannot represent it")
    optional = ("features.weight",) if iresnet else fc
    missing = [k for k in own if k not in sd and k not in optional
               and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise ValueError(f"{path} does not fit {name}: missing {missing}, "
                         f"unexpected {unexpected}")
    bad = [k for k in sd if sd[k].shape != own[k].shape]
    if bad:
        raise ValueError(f"{path} does not fit {name}: shapes differ at "
                         f"{bad}")
    backbone.load_state_dict(sd, strict=False)
