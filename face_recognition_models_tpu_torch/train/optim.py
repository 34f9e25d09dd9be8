"""Optimizer factory. Port of face_recognition_models_tpu/train/optim.py:
OPTIMIZER_CONFIGS, OPTIMIZER_DICT (1-based ids) and `get_optimizer`, with
global-norm clipping of the raw gradients before any rule.

Each rule is written from the optax 0.2.6 transformations the JAX factory
chains (optax's rules differ from torch.optim's: AdamW decays after the
moments, RMSprop adds eps inside the root, Adagrad's accumulator starts at
0.1, NAdam has no momentum-decay schedule, and torch has no Lion):

    sgd      add_decayed_weights -> trace(momentum) -> lr (torch's fused SGD)
    adam     add_decayed_weights -> scale_by_adam -> lr
    adamw    scale_by_adam -> add_decayed_weights -> lr
    rmsprop  add_decayed_weights -> scale_by_rms -> trace(momentum) -> lr
    adagrad  add_decayed_weights -> scale_by_rss -> lr
    nadam    add_decayed_weights -> scale_by_adam(nesterov), optax defaults
    adamax   add_decayed_weights -> scale_by_adamax(b1, b2) -> lr
    lion     scale_by_lion -> add_decayed_weights -> lr

Every rule is a torch.optim.Optimizer (its state_dict holds its slots),
makes its slots when it is made, and reads its lr from a 0-d float32 tensor
on the parameters' device. The rules other than sgd keep one int32 step
count for the whole optimizer on that device (optax's `count`), from which
the bias corrections are computed there. The update changes the
parameters, the slots and the count in place and reads nothing back to the
host, so it runs eagerly and inside a CUDA graph of train steps alike.
Parameters whose `.grad` is None are skipped: their slots stay as they are
(a frozen trunk's, byte for byte).

`update(params, grads, lr, emit)` is the update on explicit gradients; with
a 0-d bool tensor `emit` it commits the new parameters, slots and count only
where `emit` is true and leaves them bit for bit as they were otherwise
(train/accum.MultiSteps, optax.MultiSteps' `where(emit, new, old)`).
`load_state_dict` copies into the live slot tensors, so their addresses
stay those a CUDA graph was captured with.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

import torch
import torch.distributed as dist
from torch.optim import sgd as _sgd

# Default hyperparameters of each rule (the JAX package's OPTIMIZER_CONFIGS)
OPTIMIZER_CONFIGS = {
    "sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-4,
            "nesterov": False},
    "adam": {"lr": 0.001, "b1": 0.9, "b2": 0.999, "weight_decay": 0.0},
    "adamw": {"lr": 0.001, "b1": 0.9, "b2": 0.999, "weight_decay": 0.01},
    "rmsprop": {"lr": 0.01, "decay": 0.99, "eps": 1e-8, "weight_decay": 0.0,
                "momentum": 0.9},
    "adagrad": {"lr": 0.01, "weight_decay": 0.0},
    "nadam": {"lr": 0.001, "b1": 0.9, "b2": 0.999, "weight_decay": 0.0},
    "adamax": {"lr": 0.002, "b1": 0.9, "b2": 0.999, "weight_decay": 0.0},
    "lion": {"lr": 0.001, "b1": 0.9, "b2": 0.99, "weight_decay": 0.01},
}

OPTIMIZER_DICT = {i + 1: name for i, name in enumerate(OPTIMIZER_CONFIGS)}

_F32 = torch.float32


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        shards: Optional[List[bool]] = None, group=None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: new gradients, unchanged where the global
    norm of `grads` is below `max_norm`, else (g / norm) * max_norm. The
    choice is a device `where` of the divisor and the factor (g / 1 * 1 is
    g), never a host branch; no epsilon is added to the norm.

    With a process `group`, the gradients `shards` marks are this rank's
    shards of tensors split over the group (the class-sharded kernel over
    the mesh's model axis): their squares are summed over the group in one
    all-reduce and added to those of the others, which every rank holds
    whole, so the norm is that of the whole tensors, as optax takes it of a
    sharded array."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(shards, dtype=torch.bool, device=norms.device)
        squares = norms.square()
        sharded = torch.where(mask, squares, 0.0).sum()
        dist.all_reduce(sharded, group=group)
        norm = (torch.where(mask, 0.0, squares).sum() + sharded).sqrt()
    keep = norm < max_norm
    out = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(out, torch.where(keep, 1.0, max_norm))
    return out


class _Update:
    """The update machinery the rules share: clipping, the masked commit,
    and the state_dict loaded in place. A rule defines `slot_names`,
    `slot_init` and `_apply(params, grads, slots, lr)`."""

    slot_names: tuple = ()
    slot_init: float = 0.0

    def _setup(self, clip_grad_norm: float, count: bool) -> None:
        self.clip_grad_norm = float(clip_grad_norm or 0.0)
        self.norm_shards = None
        self._params = [p for g in self.param_groups for p in g["params"]]
        device = self._params[0].device
        self.count = (torch.zeros((), dtype=torch.int32, device=device)
                      if count else None)
        for p in self._params:
            for name in self.slot_names:
                self.state[p][name] = torch.full_like(
                    p, self.slot_init, memory_format=torch.preserve_format)

    def __getstate__(self):
        # torch.optim.Optimizer pickles (and deep-copies) only its defaults,
        # state and param_groups
        state = super().__getstate__()
        state.update({k: self.__dict__[k] for k in (
            "clip_grad_norm", "_params", "count", "slot_names")
            if k in self.__dict__})
        return state

    def shard_norm(self, params: List[torch.Tensor], group) -> None:
        """Declare `params` this rank's shards of tensors split over the
        process `group`: the clipping norm sums their squares over it
        (clip_by_global_norm)."""
        self.norm_shards = ({id(p) for p in params}, group)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor an update changes in place besides the parameters:
        the slots, parameter by parameter, and the step count."""
        slots = [v for p in self._params for v in self.state[p].values()
                 if isinstance(v, torch.Tensor)]
        return slots + ([] if self.count is None else [self.count])

    def _lr(self, lr: Optional[torch.Tensor]) -> torch.Tensor:
        if lr is not None:
            return lr
        return torch.full((), self.param_groups[0]["lr"], dtype=_F32,
                          device=self._params[0].device)

    @torch.no_grad()
    def step(self, lr: Optional[torch.Tensor] = None) -> None:
        """One update of every parameter that has a gradient, with the 0-d
        float32 tensor `lr`, or without it the group's own lr."""
        params = [p for p in self._params if p.grad is not None]
        if params:
            self.update(params, [p.grad for p in params], lr)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               lr: Optional[torch.Tensor] = None,
               emit: Optional[torch.Tensor] = None) -> None:
        """The rule's update of `params` on `grads` (left unchanged); with
        the 0-d bool tensor `emit`, committed only where it is true."""
        lr = self._lr(lr)
        if self.clip_grad_norm > 0.0:
            shards, group = None, None
            if getattr(self, "norm_shards", None) is not None:
                ids, group = self.norm_shards
                shards = [id(p) in ids for p in params]
            grads = clip_by_global_norm(grads, self.clip_grad_norm, shards,
                                        group)
        slots = [[self.state[p][name] for p in params]
                 for name in self.slot_names]
        if emit is None:
            self._apply(params, grads, slots, lr)
            if self.count is not None:
                self.count.add_(1)
            return
        kept = [[s.clone() for s in group] for group in slots]
        # params + (-lr * 0) * u = params: the parameters stay put
        self._apply(params, grads, slots, lr * emit)
        for group, old in zip(slots, kept):
            for s, o in zip(group, old):
                s.copy_(torch.where(emit, s, o))
        if self.count is not None:
            self.count.add_(emit.to(torch.int32))

    def state_dict(self):
        out = super().state_dict()
        if self.count is not None:
            out["count"] = self.count
        return out

    def load_state_dict(self, state_dict) -> None:
        """Load a state_dict of this optimizer into the live slot tensors
        and count (in place) and the group hyperparameters."""
        for i, slots in state_dict["state"].items():
            live = self.state[self._params[int(i)]]
            for name, value in slots.items():
                if isinstance(value, torch.Tensor) and name in live:
                    live[name].copy_(value)
                else:
                    live[name] = value
        for group, saved in zip(self.param_groups,
                                state_dict["param_groups"]):
            group.update({k: v for k, v in saved.items() if k != "params"})
        if self.count is not None:
            self.count.copy_(state_dict["count"])


def _decayed(grads, params, weight_decay: float):
    """add_decayed_weights: g + wd * p (new tensors), or the grads as they
    are at wd 0."""
    if not weight_decay:
        return grads
    out = torch._foreach_mul(params, weight_decay)
    torch._foreach_add_(out, grads)
    return out


def _moment(slot, g, decay: float) -> None:
    """slot = (1 - decay) * g + decay * slot, in place."""
    torch._foreach_mul_(slot, decay)
    torch._foreach_add_(slot, torch._foreach_mul(g, 1 - decay))


def _second_moment(slot, g, decay: float) -> None:
    """slot = (1 - decay) * g**2 + decay * slot, in place."""
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - decay)
    torch._foreach_mul_(slot, decay)
    torch._foreach_add_(slot, g2)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay ** count in float32, on the count's device."""
    return 1 - torch.pow(decay, count.to(_F32))


def _apply_lr(params, updates, lr: torch.Tensor) -> None:
    """params += -lr * updates (scale_by_learning_rate, apply_updates)."""
    torch._foreach_add_(params, torch._foreach_mul(updates, -lr))


class SGD(_Update, torch.optim.SGD):
    """torch.optim.SGD (its param groups and `momentum_buffer` slots, so its
    state_dict is torch's) whose update is torch's fused SGD
    (`torch._fused_sgd_`, one launch for all parameters) with a tensor lr:
    weight decay added to the gradient before the momentum accumulation,
    the ordering the JAX package's fused_sgd rebuilds. On the card its
    result with a tensor lr equals torch's default foreach SGD with the
    same lr as a float bit for bit (measured on an H100, PERF.md). The
    momentum buffers start at zero, made with the optimizer, so the first
    update (momentum * 0 + g = g) is the same code as every later one. It
    keeps no step count: the schedule reads the train state's."""

    def __init__(self, params: Iterable, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 clip_grad_norm: float = 0.0):
        torch.optim.SGD.__init__(self, params, lr=lr, momentum=momentum,
                                 weight_decay=weight_decay, nesterov=nesterov)
        self.slot_names = ("momentum_buffer",) if momentum != 0.0 else ()
        self._setup(clip_grad_norm, count=False)

    def _apply(self, params, grads, slots, lr):
        group = self.param_groups[0]
        bufs = slots[0] if slots else [None] * len(params)
        _sgd.sgd(params, grads, bufs, fused=True,
                 weight_decay=group["weight_decay"],
                 momentum=group["momentum"], lr=lr,
                 dampening=group["dampening"],
                 nesterov=group["nesterov"], maximize=group["maximize"])


class _Rule(_Update, torch.optim.Optimizer):

    def __init__(self, params: Iterable, lr: float,
                 clip_grad_norm: float = 0.0, **hyper):
        torch.optim.Optimizer.__init__(self, params, dict(lr=lr, **hyper))
        self._setup(clip_grad_norm, count=True)

    @property
    def hp(self):
        return self.param_groups[0]


class Adam(_Rule):
    """wd -> scale_by_adam(b1, b2, eps=1e-8) -> lr, or with `decoupled`
    (adamw) scale_by_adam -> wd -> lr."""

    slot_names = ("mu", "nu")

    def __init__(self, params, lr, b1=0.9, b2=0.999, weight_decay=0.0,
                 decoupled=False, clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm, b1=b1, b2=b2,
                         weight_decay=weight_decay, decoupled=decoupled,
                         eps=1e-8)

    def _apply(self, params, grads, slots, lr):
        hp = self.hp
        wd = hp["weight_decay"]
        g = grads if hp["decoupled"] else _decayed(grads, params, wd)
        mu, nu = slots
        _moment(mu, g, hp["b1"])
        _second_moment(nu, g, hp["b2"])
        c = self.count + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(hp["b1"], c))
        nu_hat = torch._foreach_div(nu, _bias_correction(hp["b2"], c))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, hp["eps"])
        u = torch._foreach_div(mu_hat, den)
        if hp["decoupled"] and wd:
            torch._foreach_add_(u, torch._foreach_mul(params, wd))
        _apply_lr(params, u, lr)


class NAdam(_Rule):
    """wd -> optax.nadam at its defaults (b1 0.9, b2 0.999, eps 1e-8: the
    JAX factory passes no override to it): scale_by_adam(nesterov=True),
    mu_hat = b1 * mu / (1 - b1^(t+1)) + (1 - b1) * g / (1 - b1^t)."""

    slot_names = ("mu", "nu")

    def __init__(self, params, lr, weight_decay=0.0, clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm, b1=0.9, b2=0.999,
                         eps=1e-8, weight_decay=weight_decay)

    def _apply(self, params, grads, slots, lr):
        hp = self.hp
        b1, b2 = hp["b1"], hp["b2"]
        g = _decayed(grads, params, hp["weight_decay"])
        mu, nu = slots
        _moment(mu, g, b1)
        _second_moment(nu, g, b2)
        c = self.count + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, c + 1))
        torch._foreach_mul_(mu_hat, b1)
        g_hat = torch._foreach_div(g, _bias_correction(b1, c))
        torch._foreach_mul_(g_hat, 1 - b1)
        torch._foreach_add_(mu_hat, g_hat)
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, c))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, hp["eps"])
        _apply_lr(params, torch._foreach_div(mu_hat, den), lr)


class RMSprop(_Rule):
    """wd -> scale_by_rms(decay, eps): g * rsqrt(nu + eps), eps inside the
    root, nu from 0 -> trace(momentum) -> lr."""

    slot_names = ("nu", "trace")

    def __init__(self, params, lr, decay=0.99, eps=1e-8, momentum=0.9,
                 weight_decay=0.0, clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm, decay=decay, eps=eps,
                         momentum=momentum, weight_decay=weight_decay)

    def _apply(self, params, grads, slots, lr):
        hp = self.hp
        g = _decayed(grads, params, hp["weight_decay"])
        nu, trace = slots
        _second_moment(nu, g, hp["decay"])
        u = torch._foreach_add(nu, hp["eps"])
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, g)
        torch._foreach_mul_(trace, hp["momentum"])
        torch._foreach_add_(trace, u)
        _apply_lr(params, trace, lr)


class Adagrad(_Rule):
    """wd -> scale_by_rss: the sum of squares starts at 0.1, the update is
    g * rsqrt(sum + 1e-7). optax writes where(sum > 0, rsqrt(...), 0); the
    sum starts at 0.1 and only grows, so its other branch never applies."""

    slot_names = ("sum_of_squares",)
    slot_init = 0.1

    def __init__(self, params, lr, weight_decay=0.0, clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm,
                         weight_decay=weight_decay)

    def _apply(self, params, grads, slots, lr):
        g = _decayed(grads, params, self.hp["weight_decay"])
        (sos,) = slots
        torch._foreach_add_(sos, torch._foreach_mul(g, g))
        u = torch._foreach_add(sos, 1e-7)
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, g)
        _apply_lr(params, u, lr)


class Adamax(_Rule):
    """wd -> optax.adamax(b1, b2, eps=1e-8): nu = max(|g| + eps, b2 * nu),
    update (mu / (1 - b1^t)) / nu."""

    slot_names = ("mu", "nu")

    def __init__(self, params, lr, b1=0.9, b2=0.999, weight_decay=0.0,
                 clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm, b1=b1, b2=b2,
                         eps=1e-8, weight_decay=weight_decay)

    def _apply(self, params, grads, slots, lr):
        hp = self.hp
        g = _decayed(grads, params, hp["weight_decay"])
        mu, nu = slots
        _moment(mu, g, hp["b1"])
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, hp["eps"])
        torch._foreach_mul_(nu, hp["b2"])
        torch._foreach_maximum_(nu, a)
        u = torch._foreach_div(mu, _bias_correction(hp["b1"],
                                                    self.count + 1))
        torch._foreach_div_(u, nu)
        _apply_lr(params, u, lr)


class Lion(_Rule):
    """scale_by_lion(b1, b2): sign((1 - b1) g + b1 mu), then mu = (1 - b2) g
    + b2 mu -> wd -> lr."""

    slot_names = ("mu",)

    def __init__(self, params, lr, b1=0.9, b2=0.99, weight_decay=0.01,
                 clip_grad_norm=0.0):
        super().__init__(params, lr, clip_grad_norm, b1=b1, b2=b2,
                         weight_decay=weight_decay)

    def _apply(self, params, grads, slots, lr):
        hp = self.hp
        (mu,) = slots
        u = torch._foreach_mul(grads, 1 - hp["b1"])
        torch._foreach_add_(u, torch._foreach_mul(mu, hp["b1"]))
        torch._foreach_sign_(u)
        _moment(mu, grads, hp["b2"])
        if hp["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      hp["weight_decay"]))
        _apply_lr(params, u, lr)


def optimizer_name(choice: Union[int, str]) -> str:
    """The rule a name or a 1-based id selects; the JAX factory's errors."""
    if isinstance(choice, int):
        if choice not in OPTIMIZER_DICT:
            raise ValueError(f"Invalid optimizer id: {choice}")
        name = OPTIMIZER_DICT[choice]
    else:
        name = choice.lower()
    if name not in OPTIMIZER_CONFIGS:
        raise ValueError(f"Unknown optimizer name: {name}. Available: "
                         f"{sorted(OPTIMIZER_CONFIGS)}")
    return name


def get_optimizer(choice: Union[int, str], params: Iterable,
                  learning_rate: float, **overrides) -> torch.optim.Optimizer:
    """The optimizer a name or 1-based id selects over `params`, with the
    rule's defaults updated by `overrides` (keys the rule does not read are
    ignored) and `clip_grad_norm` > 0 clipping the raw gradients first."""
    name = optimizer_name(choice)
    cfg = {**OPTIMIZER_CONFIGS[name], **overrides}
    clip = float(cfg.pop("clip_grad_norm", 0.0) or 0.0)
    lr, wd = learning_rate, cfg["weight_decay"]
    if name == "sgd":
        return SGD(params, lr, momentum=cfg["momentum"], weight_decay=wd,
                   nesterov=cfg["nesterov"], clip_grad_norm=clip)
    if name in ("adam", "adamw"):
        return Adam(params, lr, b1=cfg["b1"], b2=cfg["b2"], weight_decay=wd,
                    decoupled=name == "adamw", clip_grad_norm=clip)
    if name == "rmsprop":
        return RMSprop(params, lr, decay=cfg["decay"], eps=cfg["eps"],
                       momentum=cfg["momentum"], weight_decay=wd,
                       clip_grad_norm=clip)
    if name == "adagrad":
        return Adagrad(params, lr, weight_decay=wd, clip_grad_norm=clip)
    if name == "nadam":
        return NAdam(params, lr, weight_decay=wd, clip_grad_norm=clip)
    if name == "adamax":
        return Adamax(params, lr, b1=cfg["b1"], b2=cfg["b2"],
                      weight_decay=wd, clip_grad_norm=clip)
    return Lion(params, lr, b1=cfg["b1"], b2=cfg["b2"], weight_decay=wd,
                clip_grad_norm=clip)
