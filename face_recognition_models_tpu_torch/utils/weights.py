"""Weight bridge: the JAX package's parameter tree -> the port's tensors.

The trees arrive as nested dicts of numpy arrays (flax names); the port does
not import JAX. Conv kernels [H, W, I, O] become [O, I, H, W] (depthwise
[3, 3, 1, C] becomes [C, 1, 3, 3]), Dense kernels [in, out] become
[out, in], BatchNorm scale / bias / mean / var become weight / bias /
running_mean / running_var (a BatchNorm with no scale gets the port's
buffer of ones), LayerNorm scale / bias become weight / bias, PReLU's
alpha becomes weight, and the head's `kernel_w` [D, C] crosses as it is
(the port keeps the JAX layout for it). Module names map per trunk: flax's
`layer1_0` / `downsample_conv` to torchvision's `layer1.0` /
`downsample.0` (ResNet, iResNet), flax's `stem` / `block{i}_{j}` / `fc` to
torchvision's `features.*` / `classifier.1` (mobilenet_v2,
efficientnet_b0); MobileFaceNet, the ViTs and Inception-v3 keep the flax
names. The iResNet fc, which flax flattens (H, W, C), is permuted to
torch's (C, H, W). A FaceNet wrapper's single trunk goes under `trunk.`.
A leaf the bridge does not know raises; loading the result with
`load_state_dict(strict=True)` raises for a port tensor it did not write.
`head_state_from_jax` carries a head's state across the same way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _module_name(flax_name: str) -> str:
    m = re.fullmatch(r"layer(\d+)_(\d+)", flax_name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    return {"downsample_conv": "downsample.0",
            "downsample_bn": "downsample.1"}.get(flax_name, flax_name)


def _kind(params: Mapping) -> str:
    if "patch_embed" in params:
        return "vit"
    if "Mixed_5b" in params:
        return "inception"
    if "gdconv" in params:
        return "mobilefacenet"
    if "prelu" in params:
        return "iresnet"
    if "stem" in params:
        return ("efficientnet_b0" if "se" in params.get("block0_0", {})
                else "mobilenet_v2")
    return "resnet"


def _block_offsets(settings) -> Dict[str, Tuple[int, int, int]]:
    """flax block name -> (stage, index in the stage, expand ratio)."""
    return {f"block{i}_{j}": (i, j, s[0])
            for i, s in enumerate(settings) for j in range(s[2])}


_MBV2_SUB = {"expand": "0.0", "expand_bn": "0.1", "depthwise": "1.0",
             "depthwise_bn": "1.1", "project": "2", "project_bn": "3"}
_B0_SUB = {"expand": "0.0", "expand_bn": "0.1", "depthwise": "1.0",
           "depthwise_bn": "1.1", "se.reduce": "2.fc1", "se.expand": "2.fc2",
           "project": "3.0", "project_bn": "3.1"}


def _torchvision_name(kind: str, path: Tuple[str, ...]) -> str:
    """The torchvision prefix of a flax module path of mobilenet_v2 or
    efficientnet_b0."""
    from face_recognition_models_tpu_torch.models import (
        efficientnet, mobilenet)

    if kind == "mobilenet_v2":
        settings, sub, last = mobilenet._MBV2_SETTINGS, _MBV2_SUB, 18
    else:
        settings, sub, last = efficientnet._B0_SETTINGS, _B0_SUB, 8
    top = {"stem": "features.0.0", "stem_bn": "features.0.1",
           "head": f"features.{last}.0", "head_bn": f"features.{last}.1",
           "fc": "classifier.1"}
    if path[0] in top and len(path) == 1:
        return top[path[0]]
    stage, j, t = _block_offsets(settings)[path[0]]
    inner = sub[".".join(path[1:])]
    if t == 1:   # no expand stage: every index one lower
        head, _, rest = inner.partition(".")
        inner = ".".join([str(int(head) - 1)] + ([rest] if rest else []))
    if kind == "mobilenet_v2":
        feat = 1 + sum(s[2] for s in settings[:stage]) + j
        return f"features.{feat}.conv.{inner}"
    return f"features.{stage + 1}.{j}.block.{inner}"


def _torch_name(kind: str, path: Tuple[str, ...]) -> str:
    if kind in ("resnet", "iresnet"):
        return ".".join(_module_name(n) for n in path)
    if kind in ("mobilenet_v2", "efficientnet_b0"):
        return _torchvision_name(kind, path)
    return ".".join(path)


def _leaf_modules(tree: Mapping, path=()):
    """(path, dict of arrays) of every flax module holding parameters,
    and (path, array) of every raw parameter (ViT's pos_embed)."""
    for name, value in tree.items():
        if isinstance(value, Mapping):
            if value and all(not isinstance(v, Mapping)
                             for v in value.values()):
                yield path + (name,), value
            else:
                yield from _leaf_modules(value, path + (name,))
        else:
            yield path + (name,), value


def _get(tree: Optional[Mapping], path):
    for name in path:
        if not isinstance(tree, Mapping) or name not in tree:
            return None
        tree = tree[name]
    return tree


def _bridge(kind: str, params: Mapping, stats: Mapping, prefix: str,
            sd: Dict) -> None:
    used_stats = set()
    for path, p in _leaf_modules(params):
        key = prefix + _torch_name(kind, path)
        if not isinstance(p, Mapping):                  # a raw parameter
            sd[key] = _t(p)
            continue
        s = _get(stats, path)
        names = set(p)
        if s is not None:                               # BatchNorm
            if names - {"scale", "bias"} or set(s) != {"mean", "var"}:
                raise ValueError(f"unknown BatchNorm leaves at {path}: "
                                 f"{sorted(names)}, {sorted(s)}")
            sd[key + ".weight"] = (_t(p["scale"]) if "scale" in p
                                   else torch.ones(np.shape(s["mean"])))
            sd[key + ".bias"] = _t(p["bias"])
            sd[key + ".running_mean"] = _t(s["mean"])
            sd[key + ".running_var"] = _t(s["var"])
            sd[key + ".num_batches_tracked"] = torch.zeros((),
                                                           dtype=torch.long)
            used_stats.add(path)
        elif names == {"scale", "bias"}:                # LayerNorm
            sd[key + ".weight"] = _t(p["scale"])
            sd[key + ".bias"] = _t(p["bias"])
        elif names == {"alpha"}:                        # PReLU
            sd[key + ".weight"] = _t(p["alpha"])
        elif "kernel" in names and names <= {"kernel", "bias"}:
            k = np.asarray(p["kernel"], np.float32)
            if k.ndim == 4:
                w = k.transpose(3, 2, 0, 1)
            elif kind == "iresnet" and path == ("fc",):
                # flax flattens (H, W, C), torch (C, H, W)
                c = np.shape(params["bn2"]["scale"])[0]
                side = int(round((k.shape[0] // c) ** 0.5))
                w = (k.reshape(side, side, c, -1).transpose(3, 2, 0, 1)
                     .reshape(k.shape[1], -1))
            else:
                w = k.T
            sd[key + ".weight"] = _t(w)
            if "bias" in p:
                sd[key + ".bias"] = _t(p["bias"])
        else:
            raise ValueError(f"unknown JAX leaves at {path}: {sorted(names)}")
    unused = [path for path, _ in _leaf_modules(stats or {})
              if path not in used_stats]
    if unused:
        raise ValueError(f"batch_stats the bridge did not use: {unused}")


def from_jax(params: Mapping, batch_stats: Mapping
             ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """(backbone state_dict, kernel_w or None) from the JAX trees, for any
    trunk of the JAX registry or a FaceNet wrapper of one.

    `params` is either a TrainState's {'backbone': ..., 'kernel_w': ...}
    or a backbone's own param tree; `batch_stats` is the backbone's."""
    kernel_w = None
    if "backbone" in params:
        if "kernel_w" in params:
            kernel_w = _t(params["kernel_w"])
        params = params["backbone"]
    prefix = ""
    (first, *rest) = list(params)
    if not rest and re.fullmatch(r"[A-Z]\w*_0", first):   # FaceNet wrapper
        params, prefix = params[first], "trunk."
        batch_stats = (batch_stats or {}).get(first, {})
    sd: Dict[str, torch.Tensor] = {}
    _bridge(_kind(params), params, batch_stats or {}, prefix, sd)
    return sd, kernel_w


def head_state_from_jax(name: str, state: Any, device="cpu") -> Any:
    """The port's head state from a JAX head state whose leaves are numpy
    arrays (or anything np.asarray takes), field for field:
    SphereFaceState (int iter), CurricularFaceState (t), AdaFaceState (t,
    batch_mean, batch_std), VPLArcFaceState (mem [C, D], life [C],
    training_flag), QAFaceState (mem, life, muy, std, training_flag) or
    AdaCosState (s). Booleans and integers keep their type, the rest
    becomes float32. Heads without state give None."""
    from face_recognition_models_tpu_torch.heads import margins

    if state is None:
        return None
    cls = {"sphereface": margins.SphereFaceState,
           "curricularface": margins.CurricularFaceState,
           "adaface": margins.AdaFaceState,
           "vpl_arcface": margins.VPLArcFaceState,
           "qaface": margins.QAFaceState,
           "adacos": margins.AdaCosState}.get(name)
    if cls is None:
        raise ValueError(f"head '{name}' has no state to carry over")

    def leaf(field):
        x = np.asarray(getattr(state, field))
        keep = x.dtype == np.bool_ or np.issubdtype(x.dtype, np.integer)
        return torch.as_tensor(x.copy()).to(
            device=device, dtype=None if keep else torch.float32)

    return cls(*(leaf(f) for f in cls._fields))


def mtcnn_from_jax(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The MTCNN nets' state_dicts in facenet_pytorch's layout (what
    detection/mtcnn.MTCNN loads) from the JAX detector's param trees
    {'pnet': ..., 'rnet': ..., 'onet': ...}: the inverse of the JAX
    package's facenet_pytorch converter. Conv kernels [H, W, I, O] become
    [O, I, H, W], Dense kernels [in, out] become [out, in], PReLU's alpha
    becomes `prelu*.weight`."""
    out = {}
    for net, tree in params.items():
        sd = {}
        for name, leaf in tree.items():
            if "alpha" in leaf:
                sd[f"{name}.weight"] = _t(leaf["alpha"])
                continue
            k = np.asarray(leaf["kernel"], np.float32)
            sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                      else k.T)
            sd[f"{name}.bias"] = _t(leaf["bias"])
        out[net] = sd
    return out
