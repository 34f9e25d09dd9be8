"""Gradient accumulation. Port of optax.MultiSteps (optax 0.2.6,
transforms/_accumulation.py), which the JAX package's `fit` wraps around
its optimizer for `grad_accum` = K > 1 (train/loop.py:125-147).

Every micro-step folds the gradients into a running mean, acc += (g - acc)
/ (mini_step + 1), and runs the inner rule on the mean; the inner rule's new
parameters, slots and step count are committed only on the K-th micro-step
(`emit`, mini_step == K - 1), and on every other one they stay bit for bit
as they were. After an emit the mean goes back to 0. Nothing branches on
the host: `emit` is a 0-d bool tensor on the card, so a CUDA graph of train
steps may start at any phase of the K-cycle (after leftover steps, after a
resume). The lr the train step passes is the one the schedule gives the
emitting micro-step's cycle start, schedule((count // K) * K), as the JAX
package's `lr_inner`.
"""

from __future__ import annotations

from typing import List, Optional

import torch


class MultiSteps:
    """K-step gradient accumulation around an optimizer of train/optim.py.

    State on the parameters' device: `mini_step` (int32, 0-d), the fp32
    means `acc` shaped like the parameters, and the inner optimizer's own
    (its count moves on emit only). Parameters without a gradient keep a
    zero mean and are not updated."""

    def __init__(self, inner, every_k: int):
        if every_k < 2:
            raise ValueError(f"MultiSteps needs every_k >= 2, got {every_k}")
        self.inner, self.k = inner, int(every_k)
        self._params = inner._params
        device = self._params[0].device
        self.mini_step = torch.zeros((), dtype=torch.int32, device=device)
        self.acc = [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.preserve_format)
                    for p in self._params]

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def shard_norm(self, params: List[torch.Tensor], group) -> None:
        """The inner rule's shard_norm: the clipping of the means."""
        self.inner.shard_norm(params, group)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a micro-step changes in place besides the
        parameters: the inner optimizer's, `mini_step` and the means."""
        return [*self.inner.tensors(), self.mini_step, *self.acc]

    @torch.no_grad()
    def step(self, lr: Optional[torch.Tensor] = None) -> None:
        live = [i for i, p in enumerate(self._params) if p.grad is not None]
        params = [self._params[i] for i in live]
        acc = [self.acc[i] for i in live]
        emit = self.mini_step == self.k - 1
        if params:
            delta = torch._foreach_sub([p.grad for p in params], acc)
            torch._foreach_div_(delta, (self.mini_step + 1).to(torch.float32))
            torch._foreach_add_(acc, delta)
            self.inner.update(params, acc, lr, emit)
            torch._foreach_mul_(acc, (~emit).to(torch.float32))
        self.mini_step.add_(1).remainder_(self.k)

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "every_k": self.k,
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state_dict) -> None:
        """Load in place: the means and mini_step keep their addresses."""
        if state_dict["every_k"] != self.k:
            raise ValueError(f"a state of grad_accum {state_dict['every_k']}"
                             f" does not load into grad_accum {self.k}")
        self.inner.load_state_dict(state_dict["inner"])
        self.mini_step.copy_(state_dict["mini_step"])
        for x, y in zip(self.acc, state_dict["acc"], strict=True):
            x.copy_(y)
