"""Dropout and stochastic depth drawn from an explicit generator.

`torch.nn.Dropout` draws from the global generator; the port's trunks draw
every mask from the train step's generator (`TrainState.rng`), so a resumed
run and a CUDA graph of K steps (which registers that generator) draw what
an uninterrupted eager run draws. The laws are flax's: `nn.Dropout` keeps
each element with probability keep = 1 - rate and scales it by 1 / keep;
EfficientNet's stochastic depth keeps each row's residual branch the same
way (face_recognition_models_tpu/models/efficientnet.py:87-91). Under an
active mesh a mask is drawn for the global batch and each rank keeps its
rows, as the JAX step draws it at global shape.
"""

from __future__ import annotations

from typing import Optional

import torch

from face_recognition_models_tpu_torch.parallel import collectives as coll


def _keep_mask(shape, keep: float, rng: Optional[torch.Generator],
               device) -> torch.Tensor:
    if rng is None:
        raise ValueError(
            "a train-mode forward with dropout needs the step's generator: "
            "call the backbone with rng=<torch.Generator>")
    shape = (coll.global_rows(shape[0]),) + tuple(shape[1:])
    return coll.local_rows(torch.rand(shape, generator=rng,
                                      device=device)) < keep


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """flax nn.Dropout(rate)(x, deterministic=not training)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, rng, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(y: torch.Tensor, rate: float, rng: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Per-row stochastic depth of a residual branch y [N, ...]: the row is
    kept with probability 1 - rate and scaled by 1 / (1 - rate), or zero."""
    if not training or rate == 0.0:
        return y
    keep = 1.0 - rate
    mask = _keep_mask((y.shape[0],) + (1,) * (y.dim() - 1), keep, rng,
                      y.device)
    return torch.where(mask, y / keep, 0.0).to(y.dtype)
