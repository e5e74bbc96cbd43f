"""The XE train steps (the JAX package's ``train/steps.py``): forward
with dropout, masked (weighted) XE, backward, global-norm clip and the
optimizer update, optionally behind the finite-update guard; and the
step's row weights for ``TrainConfig.loss``, as the JAX trainer's XE epoch
picks them. ``stats=True`` (the flight recorder on) adds the per-family
update ratios as extra 0-dim tensor outputs; the parameter math is the
same, bit for bit.

:func:`make_xe_step` runs on one device. :func:`make_parallel_xe_step` is
its data-parallel form over a ``train.mesh.DataMesh``: each rank computes
the sum form ``(num, den)`` of its rows' loss and the gradient of ``num``,
one all-reduce sums ``num`` and ``den``, a ``parallel.comms.GradReducer``
sums the gradients, and both divide by the global ``max(den, 1)``, so the
step equals the one-device step on the concatenated batch up to float
summation order; the update then runs alike on every rank.

``row`` (both factories): the ``'mp'`` row of a model-parallel grid, whose
ranks compute the same rows (``mesh`` is then the grid's data column): the
row's first rank broadcasts the reduced gradients and the loss over it in
one flat tensor (``parallel.comms.broadcast_row``) before the update, so
the row steps bitwise alike.
"""

from __future__ import annotations

import torch

from cst_captioning_tpu_torch.losses import masked_cross_entropy
from cst_captioning_tpu_torch.train.schedule import global_norm
from cst_captioning_tpu_torch.train.state import (
    TrainState,
    guarded_apply_gradients,
)


def param_families(model: torch.nn.Module) -> list[str]:
    """The JAX parameter tree's top-level family of each parameter, in
    ``model.parameters()`` order: ``encoder``, ``cell``, ``init_c<l>``,
    ``init_h<l>`` (``convert.py``'s layout)."""
    out = []
    for name, _ in model.named_parameters():
        head, rest = name.split(".", 1)
        out.append(head + rest.split(".", 1)[0]
                   if head in ("init_c", "init_h") else head)
    return out


def update_ratios(old, new, families: list[str]) -> dict[str, torch.Tensor]:
    """Per-family relative update magnitude, on the device: for each family
    ``upd_ratio/<fam> = ||new - old|| / max(||old||, 1e-12)`` over its
    parameters, plus ``upd_ratio/global`` over all (the JAX package's
    ``train/steps._update_ratios``; a healthy Adam step sits near 1e-3).
    0-dim float32 tensors: nothing is read back here."""
    groups: dict[str, list[int]] = {}
    for i, fam in enumerate(families):
        groups.setdefault(fam, []).append(i)
    d2 = [(n.detach().float() - o.float()).pow(2).sum()
          for o, n in zip(old, new)]
    o2 = [o.float().pow(2).sum() for o in old]

    def ratio(idx):
        num = torch.stack([d2[i] for i in idx]).sum().sqrt()
        den = torch.stack([o2[i] for i in idx]).sum().sqrt()
        return num / torch.clamp(den, min=1e-12)

    out = {f"upd_ratio/{fam}": ratio(idx) for fam, idx in groups.items()}
    out["upd_ratio/global"] = ratio(range(len(families)))
    return out


def _apply(state: TrainState, grads, loss, gnorm, guard: bool,
           key: str = "loss", stats: bool = False):
    """Optionally guarded update -> (state, metrics); ``key`` names the
    loss ("loss" for XE, "rl_loss" for REINFORCE). The loss and grad norm
    come back as Python floats; ``stats=True`` adds the update ratios
    (:func:`update_ratios`), from a detached copy of the parameters taken
    before the update."""
    old = [p.detach().clone() for p in state.params] if stats else None
    if guard:
        state, nonfinite = guarded_apply_gradients(state, grads, loss, gnorm)
        metrics = {key: float(loss), "grad_norm": float(gnorm),
                   "nonfinite": nonfinite}
    else:
        state.apply_gradients(grads)
        metrics = {key: float(loss), "grad_norm": float(gnorm)}
    if stats:
        metrics.update(update_ratios(old, state.params,
                                     param_families(state.model)))
    return state, metrics


def _local_loss_sums(state: TrainState, feats, masks, labels, mask,
                     weights, label_smoothing: float, rank: int = 0):
    """(numerator, denominator) of the masked XE on these rows, dropout
    from the step's generator (folded with ``rank``)."""
    model = state.model
    model.train()
    logits = model(feats, masks, labels, train=True,
                   generator=state.dropout_generator(rank))
    w_mask = mask.float() * weights.float()[:, None]
    den = w_mask.sum()
    # masked_cross_entropy normalizes; the sum form lets the global
    # normalization come after the cross-rank reduce
    num = masked_cross_entropy(logits, labels, mask, weights=weights,
                               label_smoothing=label_smoothing) * den
    return num, den


def xe_loss_and_grads(state: TrainState, feats, masks, labels, mask,
                      weights, label_smoothing: float = 0.0):
    """(loss, grads in ``state.params`` order) of the masked XE with
    dropout drawn from the step's generator."""
    num, den = _local_loss_sums(state, feats, masks, labels, mask, weights,
                                label_smoothing)
    loss = num / torch.clamp(den, min=1.0)
    grads = torch.autograd.grad(loss, state.params)
    return loss.detach(), grads



def row_sync(grads, loss: torch.Tensor, row):
    """The ``'mp'`` row's first rank's (gradients, loss) on every rank of
    ``row`` (module docstring); as given without a row."""
    if row is None:
        return grads, loss
    from cst_captioning_tpu_torch.parallel.comms import broadcast_row

    *grads, loss = broadcast_row([*grads, loss], row)
    return grads, loss


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
                 guard: bool = False, stats: bool = False, row=None):
    """-> step(state, feats, masks, labels, mask, weights) -> (state,
    metrics). The state (over ``model``) is updated in place; ``guard``
    adds the ``nonfinite`` metric and skips a non-finite update;
    ``stats`` adds the update ratios; ``row`` as the module docstring."""
    del model  # the state carries it; kept for the JAX factory's signature

    def step(state: TrainState, feats, masks, labels, mask, weights):
        loss, grads = xe_loss_and_grads(state, feats, masks, labels, mask,
                                        weights, label_smoothing)
        grads, loss = row_sync(grads, loss, row)
        return _apply(state, grads, loss, global_norm(grads), guard,
                      stats=stats)

    return step


def make_parallel_xe_step(model, mesh, label_smoothing: float = 0.0,
                          guard: bool = False, comm=None,
                          stats: bool = False, row=None):
    """-> step(state, feats, masks, labels, mask, weights) -> (state,
    metrics) over this rank's rows of the global batch (module docstring).
    ``comm`` (``parallel.comms.CommConfig``) selects the gradient
    all-reduce: None is one all-reduce a leaf; f32 buckets are bitwise
    equal to it at two ranks. The loss and grad norm in the metrics are
    the global ones, the same on every rank."""
    # parallel.comms imports train.mesh, whose package imports this module
    from cst_captioning_tpu_torch.parallel.comms import (
        GradReducer,
        reduce_sums,
    )
    from cst_captioning_tpu_torch.train.mesh import param_leaves

    reduce = GradReducer(param_leaves(model), mesh, comm)

    def step(state: TrainState, feats, masks, labels, mask, weights):
        num, den = _local_loss_sums(state, feats, masks, labels, mask,
                                    weights, label_smoothing, mesh.rank)
        grads_num = torch.autograd.grad(num, state.params)
        num_t, den_t = reduce_sums(num, den, mesh)
        den_t = torch.clamp(den_t, min=1.0)
        grads, loss = row_sync([g / den_t for g in reduce(grads_num)],
                               num_t / den_t, row)
        return _apply(state, grads, loss, global_norm(grads), guard,
                      stats=stats)

    return step