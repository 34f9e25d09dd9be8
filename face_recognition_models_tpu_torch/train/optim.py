"""Optimizer factory. Port of the `sgd` entry of
face_recognition_models_tpu/train/optim.py.

torch.optim.SGD adds weight decay to the gradient before the momentum
accumulation, which is the ordering the JAX package's fused_sgd rebuilds.
"""

from __future__ import annotations

from typing import Iterable

import torch


def get_optimizer(name: str, params: Iterable, learning_rate: float,
                  momentum: float = 0.9, weight_decay: float = 5e-4,
                  nesterov: bool = False) -> torch.optim.Optimizer:
    if name.lower() != "sgd":
        raise ValueError(f"optimizer '{name}' is not ported yet (sgd only)")
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)
