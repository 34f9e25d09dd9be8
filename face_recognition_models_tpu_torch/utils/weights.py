"""Weight bridge: the JAX package's parameter tree -> the port's tensors.

The trees arrive as nested dicts of numpy arrays (flax names); the port does
not import JAX. Conv kernels [H, W, I, O] become [O, I, H, W], Dense kernels
[in, out] become [out, in], BatchNorm scale / bias / mean / var become
weight / bias / running_mean / running_var, and the head's `kernel_w` [D, C]
crosses as it is (the port keeps the JAX layout for it).
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


def _walk(params: Mapping, stats: Mapping, prefix: str, sd: Dict) -> None:
    for name, p in params.items():
        key = prefix + _module_name(name)
        s = stats.get(name, {}) if stats else {}
        if "scale" in p:  # BatchNorm
            sd[key + ".weight"] = _t(p["scale"])
            sd[key + ".bias"] = _t(p["bias"])
            sd[key + ".running_mean"] = _t(s["mean"])
            sd[key + ".running_var"] = _t(s["var"])
            sd[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        elif "kernel" in p:
            k = np.asarray(p["kernel"], np.float32)
            sd[key + ".weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                     else k.T)
            if "bias" in p:
                sd[key + ".bias"] = _t(p["bias"])
        else:
            _walk(p, s, key + ".", sd)


def from_jax(params: Mapping, batch_stats: Mapping
             ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """(backbone state_dict, kernel_w or None) from the JAX trees.

    `params` is either a TrainState's {'backbone': ..., 'kernel_w': ...}
    or a backbone's own param tree; `batch_stats` is the backbone's."""
    kernel_w = None
    if "backbone" in params:
        if "kernel_w" in params:
            kernel_w = _t(params["kernel_w"])
        params = params["backbone"]
    sd: Dict[str, torch.Tensor] = {}
    _walk(params, batch_stats, "", sd)
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
