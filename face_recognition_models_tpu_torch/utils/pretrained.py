"""Backbone initialisation from a torchvision state_dict on disk (`train
--pretrained`). Port of `load_pretrained_backbone` of
face_recognition_models_tpu/utils/torch_port.py for the port's trunks.

The reference trains from ImageNet-pretrained torchvision weights
(backbones.py:12-26). The port's ResNets already use torchvision's
parameter names, so a torchvision resnet18 / resnet50 state_dict loads key
for key. Its 1000-class `fc` does not fit the 512-d embedding layer and is
left out, as the JAX loader leaves it out; an `fc` of the embedding's shape
is loaded. Any other missing or unexpected key raises. A file without
`num_batches_tracked` counters (older torchvision files) keeps the
model's own.
"""

from __future__ import annotations

import torch
from torch import nn

_PORTED = ("resnet18", "resnet50")


def load_pretrained_backbone(path: str, backbone_name: str,
                             backbone: nn.Module) -> None:
    """Load the torch state_dict file `path` into `backbone` (a
    `backbone_name` trunk, on any device) in place. The file is read on the
    CPU; a bare state_dict or one wrapped under 'state_dict' or 'model'."""
    name = backbone_name.lower()
    if name not in _PORTED:
        raise ValueError(f"--pretrained supports {sorted(_PORTED)}; got "
                         f"'{backbone_name}'")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and wrapper in sd and not hasattr(
                sd[wrapper], "shape"):
            sd = sd[wrapper]
    own = backbone.state_dict()
    sd = dict(sd)
    if "fc.weight" in sd and sd["fc.weight"].shape != own["fc.weight"].shape:
        sd.pop("fc.weight")
        sd.pop("fc.bias", None)
    fc = ("fc.weight", "fc.bias")
    missing = [k for k in own if k not in sd and k not in fc
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
