"""BatchNorm folding for inference. Port of face_recognition_models_tpu/
models/folding.py.

In eval mode a BatchNorm is a fixed per-channel affine, so it folds into
the conv before it:

    g       = weight / sqrt(running_var + eps)
    weight' = conv_weight * g        (over the output channel)
    bias'   = bias - running_mean * g

computed in float64 and written as float32, as the JAX package does. The
result is the state_dict of `ResNet(folded=True)` (models/resnet.py), whose
convs carry these biases and whose norms are the identity. Training
checkpoints are untouched: folding happens at export (`export --fold-bn`,
serving/export.py).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

# conv -> the BatchNorm after it, by state_dict key prefix
_CONV_BN = ((re.compile(r"^(|.*\.)conv(\d+)$"), r"\1bn\2"),
            (re.compile(r"^(.*\.downsample)\.0$"), r"\1.1"))


def _bn_of(conv: str) -> str:
    for pattern, repl in _CONV_BN:
        if pattern.match(conv):
            return pattern.sub(repl, conv)
    raise ValueError(f"no BatchNorm follows {conv!r}")


def fold_resnet_bn(state_dict: Dict[str, torch.Tensor], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """The state_dict of `ResNet(..., folded=True)` from a ResNet's
    state_dict (parameters and running statistics), on the CPU."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for key, w in sd.items():
        if not key.endswith(".weight") or w.dim() != 4:
            continue
        conv = key[:-len(".weight")]
        bn = _bn_of(conv)
        g = (sd[bn + ".weight"].double()
             / torch.sqrt(sd[bn + ".running_var"].double() + eps))
        out[conv + ".weight"] = (w.double() * g[:, None, None, None]
                                 ).float().contiguous()
        out[conv + ".bias"] = (sd[bn + ".bias"].double()
                               - sd[bn + ".running_mean"].double() * g
                               ).float()
    out["fc.weight"] = sd["fc.weight"].contiguous()
    out["fc.bias"] = sd["fc.bias"]
    return out
