"""Optimizer factory. Port of the `sgd` entry of
face_recognition_models_tpu/train/optim.py.

`SGD` is torch.optim.SGD (its param groups and its `momentum_buffer` slots,
so its state_dict is torch's) with a step that reads the lr from a 0-d
float32 tensor on the parameters' device: a CUDA graph of train steps holds
the update, and each replay takes the lr its schedule computed on the card.
The update is torch's fused SGD (`torch._fused_sgd_`, one launch for all
parameters): weight decay added to the gradient before the momentum
accumulation, the ordering the JAX package's fused_sgd rebuilds. On the
card its result with a tensor lr equals torch's default foreach SGD with
the same lr as a float bit for bit (measured on an H100, PERF.md). The
momentum buffers start at zero, made with the optimizer, so the first
update (momentum * 0 + g = g) is the same code as every later one and its
buffers already exist when a graph is captured.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch.optim import sgd as _sgd


class SGD(torch.optim.SGD):

    def __init__(self, params: Iterable, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        if momentum != 0.0:
            for group in self.param_groups:
                for p in group["params"]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, lr: Optional[torch.Tensor] = None) -> None:
        """One update of every parameter that has a gradient, with the 0-d
        float32 tensor `lr` (on the parameters' device), or without it each
        group's own `lr`."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            group_lr = (torch.full((), group["lr"], dtype=torch.float32,
                                   device=params[0].device)
                        if lr is None else lr)
            bufs = [self.state[p].get("momentum_buffer") for p in params]
            _sgd.sgd(params, [p.grad for p in params], bufs, fused=True,
                     weight_decay=group["weight_decay"],
                     momentum=group["momentum"], lr=group_lr,
                     dampening=group["dampening"],
                     nesterov=group["nesterov"], maximize=group["maximize"])


def get_optimizer(name: str, params: Iterable, learning_rate: float,
                  momentum: float = 0.9, weight_decay: float = 5e-4,
                  nesterov: bool = False) -> SGD:
    if name.lower() != "sgd":
        raise ValueError(f"optimizer '{name}' is not ported yet (sgd only)")
    return SGD(params, lr=learning_rate, momentum=momentum,
               weight_decay=weight_decay, nesterov=nesterov)
