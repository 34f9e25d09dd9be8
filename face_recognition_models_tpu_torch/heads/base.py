"""Margin-head framework.

Port of face_recognition_models_tpu/heads/base.py. A head is a bundle of
plain functions over tensors:

    kernel = init_kernel(cfg, generator, device)   # [D, C] class prototypes
    state  = init_state(cfg, device)               # head state (or None)
    out    = apply(cfg, kernel, feats, labels, state, minput=None)

`minput` is the feature of a second, degraded view of the batch; only heads
with `requires_minput` (QAFace) read it.

All head math is fp32 whatever the backbone's compute dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch


class HeadOutput(NamedTuple):
    pre_logits: torch.Tensor  # margin-free scaled logits [N, C] (accuracy)
    logits: torch.Tensor      # post-margin scaled logits [N, C] (CE loss)
    norms: torch.Tensor       # per-sample feature norms [N, 1]
    loss_g: torch.Tensor      # scalar auxiliary loss (MagFace regulariser)
    one_hot: torch.Tensor     # [N, C] target mask
    state: Any                # updated head state


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """[N, C] one-hot; a label outside [0, C) (-1: ignore) gives an all-zero
    row, as jax.nn.one_hot does. The heads' target mask, and the loss's and
    the metrics' target selection."""
    cols = torch.arange(num_classes, device=labels.device)
    return (labels.long()[:, None] == cols[None, :]).to(dtype)


class Head(NamedTuple):
    name: str
    init_kernel: Callable[..., torch.Tensor]
    init_state: Callable[..., Any]
    apply: Callable[..., HeadOutput]
    requires_minput: bool = False  # QAFace needs a second (degraded) view


_REGISTRY: Dict[str, Head] = {}


def register_head(head: Head) -> Head:
    _REGISTRY[head.name] = head
    return head


def get_head(name: str) -> Head:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown head '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_heads():
    return sorted(_REGISTRY)
