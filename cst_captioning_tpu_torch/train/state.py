"""TrainState (model, optimizer state, step, dropout seed) and the
finite-update guard (the JAX package's ``train/state.py`` and
``resilience/guard.py``).

The state is updated in place: the model's parameters are written over
and the optimizer state is replaced, so a caller that wants to replay a
state keeps a :meth:`TrainState.clone`. The dropout masks of step ``s``
come from a generator seeded with ``(seed, s)``: a step that the guard
rejects leaves ``step`` where it was, so its replay draws the same masks,
as the JAX step folds ``state.step`` into its key.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from cst_captioning_tpu_torch.train.schedule import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    tx: Optimizer
    opt_state: dict
    step: int = 0
    seed: int = 0
    _leaves: list | None = field(default=None, init=False, repr=False,
                                 compare=False)

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return list(self.model.parameters())

    @property
    def leaves(self):
        """The JAX leaves of the parameters (``train.mesh.param_leaves``,
        found once), which the global norm of a bfloat16 tree sums by;
        None for float32 parameters, whose norm does not need them."""
        if all(p.dtype == torch.float32 for p in self.model.parameters()):
            return None
        if self._leaves is None:
            from cst_captioning_tpu_torch.train.mesh import param_leaves

            self._leaves = param_leaves(self.model)
        return self._leaves

    def dropout_generator(self, rank: int = 0) -> torch.Generator:
        """The dropout stream of this step, on the model's device; a
        data-parallel ``rank`` other than 0 folds into the seed (as the
        JAX step folds the axis index), so ranks draw distinct masks and
        rank 0 draws the one-device step's. On a ``('data', 'seq')``
        grid ``rank`` is the data coordinate, never the seq one: every
        dropout site lies on the replicated path, and a row's equal masks
        keep it replicated."""
        g = torch.Generator(device=self.model.device)
        seed = (self.seed * 1_000_003 + self.step) % (2**63)
        if rank:
            seed = (seed ^ (rank * 0x9E3779B97F4A7C15)) % (2**63)
        g.manual_seed(seed)
        return g

    def apply_gradients(self, grads) -> "TrainState":
        params = self.params
        updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                 params, self.leaves)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        self.step += 1
        return self

    def clone(self) -> "TrainState":
        return copy.deepcopy(self)


def create_train_state(model: torch.nn.Module, tx: Optimizer,
                       seed: int = 0) -> TrainState:
    """A fresh state over ``model``'s current parameters."""
    return TrainState(model=model, tx=tx, opt_state=tx.init(
        [p.detach() for p in model.parameters()]), step=0, seed=seed)


def guarded_apply_gradients(state: TrainState, grads, loss: torch.Tensor,
                            grad_norm: torch.Tensor):
    """-> (state, nonfinite): a non-finite loss or grad norm leaves the
    params, the optimizer state and the step untouched (any NaN or inf in a
    gradient makes the global norm non-finite). Reading the two scalars
    waits for the step's device work. A skipped update still takes the
    moments to the dtype the update would have given them, as the JAX
    guard's select of the old state against the new one does (float32
    gradients of bfloat16 parameters: ``Optimizer.widen``)."""
    ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
    if ok:
        state.apply_gradients(grads)
    else:
        state.opt_state = state.tx.widen(state.opt_state, grads)
    return state, 0.0 if ok else 1.0
