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

Dtypes follow optax's (and jnp's) at every leaf: the moments start in the
parameter's dtype, each Python constant (the decays, eps, the clip, the
learning rate, the weight decay) is rounded to the dtype of the tensor it
meets, as a weakly typed jnp scalar is, and a binary operation on two
dtypes computes in the wider one. Adam's bias corrections ``1 - decay**
count`` are float32 and then rounded to the moment's dtype before the
division. So float32 gradients of bfloat16 parameters (the data-parallel
and chunked steps divide by a float32 denominator: ``train.steps.
divide_grads``) widen the moments to float32 from that update on, as
optax's do; the parameters keep their dtype (the update is added in the
wider dtype and rounded back, optax's ``apply_updates``). The global norm
is optax's ``sum(jnp.sum(x * x))``: each JAX leaf's squares summed in
float32 and rounded to the leaf's dtype, the leaves' sums added in that
dtype in JAX flatten order (``train.mesh.param_leaves``; one leaf a
tensor for a float32 model). So at ``param_dtype="bfloat16"`` the update
is optax's op for op (unjitted: XLA's fusions may skip a rounding, within
one bfloat16 ulp), and at float32 it is unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
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


@functools.lru_cache(maxsize=512)
def as_dtype(x: float, dtype: torch.dtype) -> float:
    """The Python float ``x`` rounded to ``dtype`` (through float32, as a
    weakly typed jnp scalar meets a leaf of that dtype), still a Python
    float: a tensor times it then rounds once, in ``dtype``."""
    return float(torch.tensor(float(np.float32(x))).to(dtype))


def global_norm(tensors: Sequence[torch.Tensor], leaves=None) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares over all leaves,
    optax's op for op (module docstring): ``leaves`` are the JAX leaves
    (``train.mesh.param_leaves``; default one leaf a tensor)."""
    if leaves is None:
        parts = list(tensors)
    else:
        flat = [t.reshape(-1) for t in tensors]
        parts = [flat[lf.param][lf.offset:lf.offset + lf.numel]
                 for lf in leaves]
    total = None
    for x in parts:
        s = torch.sum((x * x).float()).to(x.dtype)
        total = s if total is None else total + s
    return torch.sqrt(total)


class Optimizer:
    """The optax chain as a pure function of (grads, state, params): the
    state is a dict of moment tensors (in the parameters' dtypes, or wider
    after wider gradients) and an update count; ``update`` returns new
    tensors and leaves its inputs alone."""

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

    def widen(self, state: dict, grads) -> dict:
        """``state`` with each moment in the dtype an update by ``grads``
        would give it (jnp's promotion of the two), its values kept."""
        return {k: [m.to(torch.promote_types(m.dtype, g.dtype))
                    for m, g in zip(v, grads)] if isinstance(v, list) else v
                for k, v in state.items()}

    def update(self, grads, state: dict, params, leaves=None):
        """-> (updates to add to the params, new state). ``leaves``: the
        JAX leaves of the clip's global norm (:func:`global_norm`)."""
        q = as_dtype
        if self.grad_clip > 0:
            g_norm = global_norm(grads, leaves)
            grads = [torch.where(g_norm < q(self.grad_clip, g.dtype), g,
                                 (g / g_norm.to(g.dtype))
                                 * q(self.grad_clip, g.dtype))
                     for g in grads]
        count = state["count"]
        new = {"count": count + 1}
        if self.name in ("adam", "adamw"):
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu = [q(1 - b1, g.dtype) * g + q(b1, m.dtype) * m
                  for g, m in zip(grads, state["mu"])]
            nu = [q(1 - b2, g.dtype) * (g * g) + q(b2, v.dtype) * v
                  for g, v in zip(grads, state["nu"])]
            # optax's bias corrections, 1 - decay**count, are float32
            # (computed in float64 they differ by 1e-5 relative at step 1),
            # rounded to the moment's dtype for the division
            c1 = float(1 - np.float32(b1) ** np.float32(count + 1))
            c2 = float(1 - np.float32(b2) ** np.float32(count + 1))
            upd = [(m / q(c1, m.dtype))
                   / (torch.sqrt(v / q(c2, v.dtype)) + q(eps, v.dtype))
                   for m, v in zip(mu, nu)]
            if self.name == "adamw":
                upd = [u + q(self.weight_decay, p.dtype) * p
                       for u, p in zip(upd, params)]
            new.update(mu=mu, nu=nu)
        elif self.name == "rmsprop":
            decay, eps = 0.9, 1e-8
            nu = [q(1 - decay, g.dtype) * (g * g) + q(decay, v.dtype) * v
                  for g, v in zip(grads, state["nu"])]
            # rsqrt in float32, then rounded (jnp's for bfloat16; torch's
            # own bfloat16 rsqrt differs by an ulp on 0.2% of inputs)
            upd = [torch.rsqrt((v + q(eps, v.dtype)).float()).to(v.dtype) * g
                   for g, v in zip(grads, nu)]
            new.update(nu=nu)
        else:
            upd = list(grads)
        step_size = -self.lr(count)
        return [q(step_size, u.dtype) * u for u in upd], new


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   lr_override: float | None = None) -> Optimizer:
    lr = ((lambda count: lr_override) if lr_override is not None
          else make_lr_schedule(cfg, steps_per_epoch))
    return Optimizer(cfg.optimizer, lr, cfg.grad_clip, cfg.weight_decay)
