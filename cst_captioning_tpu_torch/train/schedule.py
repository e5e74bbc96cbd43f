"""LR schedules and the optimizer chain, as the JAX package's
``train/schedule.py`` builds them with optax.

:class:`Optimizer` reproduces the optax chain
``clip_by_global_norm(grad_clip) -> adam | adamw | sgd | rmsprop ->
scale_by_learning_rate(schedule)`` update rule for update rule, with optax's
defaults: adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
correction), adamw (adam, then ``+ weight_decay * param``), sgd (no
momentum), rmsprop (decay 0.9, eps 1e-8 inside the square root, no bias
correction, no momentum). The clip is optax's: ``g * max_norm / norm`` only
when ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6
and is another function). The learning rate of update ``n`` (0-based) is
``schedule(n)``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from cst_captioning_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """Step-wise exponential decay: lr * decay^(epoch // decay_every)."""
    if cfg.lr_decay_every <= 0 or cfg.lr_decay >= 1.0:
        return lambda count: cfg.lr
    transition = cfg.lr_decay_every * max(steps_per_epoch, 1)

    def schedule(count: int) -> float:
        if count <= 0:
            return cfg.lr
        return cfg.lr * cfg.lr_decay ** math.floor(count / transition)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares over all leaves."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    """The optax chain as a pure function of (grads, state, params): the
    state is a dict of float32 tensors and an update count; ``update``
    returns new tensors and leaves its inputs alone."""

    def __init__(self, name: str, lr: Schedule, grad_clip: float = 0.0,
                 weight_decay: float = 0.0):
        if name not in ("adam", "adamw", "sgd", "rmsprop"):
            raise ValueError(
                f"unknown optimizer {name!r}; have "
                "['adam', 'adamw', 'rmsprop', 'sgd']")
        self.name = name
        self.lr = lr
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state = {"count": 0}
        if self.name in ("adam", "adamw"):
            state.update(mu=zeros(), nu=zeros())
        elif self.name == "rmsprop":
            state.update(nu=zeros())
        return state

    def update(self, grads, state: dict, params):
        """-> (updates to add to the params, new state)."""
        if self.grad_clip > 0:
            g_norm = global_norm(grads)
            grads = [torch.where(g_norm < self.grad_clip, g,
                                 (g / g_norm) * self.grad_clip)
                     for g in grads]
        count = state["count"]
        new = {"count": count + 1}
        if self.name in ("adam", "adamw"):
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
            nu = [(1 - b2) * (g * g) + b2 * v
                  for g, v in zip(grads, state["nu"])]
            c1 = 1 - b1 ** (count + 1)
            c2 = 1 - b2 ** (count + 1)
            upd = [(m / c1) / (torch.sqrt(v / c2) + eps)
                   for m, v in zip(mu, nu)]
            if self.name == "adamw":
                upd = [u + self.weight_decay * p for u, p in zip(upd, params)]
            new.update(mu=mu, nu=nu)
        elif self.name == "rmsprop":
            decay, eps = 0.9, 1e-8
            nu = [(1 - decay) * (g * g) + decay * v
                  for g, v in zip(grads, state["nu"])]
            upd = [torch.rsqrt(v + eps) * g for g, v in zip(grads, nu)]
            new.update(nu=nu)
        else:
            upd = list(grads)
        step_size = -self.lr(count)
        return [step_size * u for u in upd], new


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   lr_override: float | None = None) -> Optimizer:
    lr = ((lambda count: lr_override) if lr_override is not None
          else make_lr_schedule(cfg, steps_per_epoch))
    return Optimizer(cfg.optimizer, lr, cfg.grad_clip, cfg.weight_decay)
