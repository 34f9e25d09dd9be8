"""Margin-head framework.

Port of face_recognition_models_tpu/heads/base.py. A head is a bundle of
plain functions over tensors:

    kernel = init_kernel(cfg, generator, device)   # [D, C] class prototypes
    state  = init_state(cfg)                       # head state (or None)
    out    = apply(cfg, kernel, feats, labels, state)

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


class Head(NamedTuple):
    name: str
    init_kernel: Callable[..., torch.Tensor]
    init_state: Callable[..., Any]
    apply: Callable[..., HeadOutput]


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
