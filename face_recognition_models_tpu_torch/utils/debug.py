"""Debug helpers. Port of face_recognition_models_tpu/utils/debug.py.

- `infer_and_compute_loss`: one batch through backbone + head, the loss
  printed (the reference's debug.py sanity helper).
- `enable_nan_checks`: the counterpart of JAX's `jax_debug_nans`, which
  raises FloatingPointError at the first operation that makes a NaN. Here
  every module's forward output and every module's input gradient is
  checked as it is made, and the first that is not finite raises
  FloatingPointError naming the module; autograd's anomaly mode also
  raises (a RuntimeError naming the backward function) at a non-finite
  gradient of an operation outside a module, such as the loss's. Each
  check reads a flag back from the device, so a checked run waits for the
  card at every module and is much slower. A CUDA graph cannot be checked
  operation by operation (a capture cannot read back to the host), so
  `--debug-nans` refuses `train --scan-steps K` with K > 1; run K = 1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _non_finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return (x.is_floating_point() and x.numel() > 0
                and not bool(torch.isfinite(x).all()))
    if isinstance(x, (tuple, list)):
        return any(_non_finite(v) for v in x)
    if isinstance(x, dict):
        return any(_non_finite(v) for v in x.values())
    return False


class NanChecks:
    """The hooks and anomaly mode enable_nan_checks turned on; `remove()`
    turns them off again."""

    def __init__(self):
        self._anomaly = torch.is_anomaly_enabled()
        self._handles = [
            nn.modules.module.register_module_forward_hook(self._forward),
            nn.modules.module.register_module_full_backward_hook(
                self._backward)]
        torch.autograd.set_detect_anomaly(True)

    @staticmethod
    def _forward(module, inputs, output):
        if _non_finite(output):
            raise FloatingPointError(
                f"non-finite output of {type(module).__name__} "
                f"({module.extra_repr() or 'no arguments'})")

    @staticmethod
    def _backward(module, grad_input, grad_output):
        if _non_finite(grad_input):
            raise FloatingPointError(
                f"non-finite input gradient of {type(module).__name__} "
                f"({module.extra_repr() or 'no arguments'})")

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        torch.autograd.set_detect_anomaly(self._anomaly)


def enable_nan_checks() -> NanChecks:
    """Raise at the first non-finite module output or gradient in this
    process (module docstring); the returned handle's remove() ends it."""
    return NanChecks()


def infer_and_compute_loss(backbone: nn.Module, head, head_cfg,
                           kernel: torch.Tensor, images: torch.Tensor,
                           labels: torch.Tensor, state=None,
                           rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """One batch through the backbone (eval mode; the module holds its
    weights, where the JAX function takes them as `variables`) and the
    head's eager apply: prints and returns the CE loss."""
    from face_recognition_models_tpu_torch.train.losses import (
        mean_cross_entropy)

    backbone.eval()
    with torch.no_grad():
        feats = backbone(images)
        if rng is None:
            rng = torch.Generator(device=feats.device).manual_seed(0)
        out = head.apply(head_cfg, kernel, feats.to(torch.float32), labels,
                         state, rng=rng)
        loss = mean_cross_entropy(out.logits, labels)
    print(f"[debug] feats {tuple(feats.shape)} "
          f"norm_mean={float(out.norms.mean()):.3f} "
          f"loss={float(loss):.4f} loss_g={float(out.loss_g):.6f}")
    return loss
