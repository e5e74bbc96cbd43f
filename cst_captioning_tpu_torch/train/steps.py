"""The XE train step for one device (the JAX package's ``train/steps.py``
``make_xe_step``): forward with dropout, masked (weighted) XE, backward,
global-norm clip and the optimizer update, optionally behind the
finite-update guard; and the step's row weights for ``TrainConfig.loss``,
as the JAX trainer's XE epoch picks them. The flight recorder's ``stats``
outputs come with the observability slice; data parallelism with its slice.
"""

from __future__ import annotations

import torch

from cst_captioning_tpu_torch.losses import masked_cross_entropy
from cst_captioning_tpu_torch.train.schedule import global_norm
from cst_captioning_tpu_torch.train.state import (
    TrainState,
    guarded_apply_gradients,
)


def _apply(state: TrainState, grads, loss, gnorm, guard: bool,
           key: str = "loss"):
    """Optionally guarded update -> (state, metrics of Python floats);
    ``key`` names the loss ("loss" for XE, "rl_loss" for REINFORCE)."""
    if guard:
        state, nonfinite = guarded_apply_gradients(state, grads, loss, gnorm)
        return state, {key: float(loss), "grad_norm": float(gnorm),
                       "nonfinite": nonfinite}
    state.apply_gradients(grads)
    return state, {key: float(loss), "grad_norm": float(gnorm)}


def xe_loss_and_grads(state: TrainState, feats, masks, labels, mask,
                      weights, label_smoothing: float = 0.0):
    """(loss, grads in ``state.params`` order) of the masked XE with
    dropout drawn from the step's generator."""
    model = state.model
    model.train()
    logits = model(feats, masks, labels, train=True,
                   generator=state.dropout_generator())
    w_mask = mask.float() * weights.float()[:, None]
    den = w_mask.sum()
    num = masked_cross_entropy(logits, labels, mask, weights=weights,
                               label_smoothing=label_smoothing) * den
    loss = num / torch.clamp(den, min=1.0)
    grads = torch.autograd.grad(loss, state.params)
    return loss.detach(), grads


def xe_row_weights(loss: str, weights: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The ``weights`` argument of the XE step: 1 on the batch's valid rows
    for ``loss="xe"``, their consensus weights for ``"wxe"``; 0 on
    wrap-padding rows either way."""
    if loss == "xe":
        return valid.float()
    if loss == "wxe":
        return weights.float() * valid.float()
    raise ValueError(f"unknown loss {loss!r} (expected 'xe' or 'wxe')")


def make_xe_step(model=None, label_smoothing: float = 0.0,
                 guard: bool = False):
    """-> step(state, feats, masks, labels, mask, weights) -> (state,
    metrics). The state (over ``model``) is updated in place; ``guard``
    adds the ``nonfinite`` metric and skips a non-finite update."""
    del model  # the state carries it; kept for the JAX factory's signature

    def step(state: TrainState, feats, masks, labels, mask, weights):
        loss, grads = xe_loss_and_grads(state, feats, masks, labels, mask,
                                        weights, label_smoothing)
        return _apply(state, grads, loss, global_norm(grads), guard)

    return step
