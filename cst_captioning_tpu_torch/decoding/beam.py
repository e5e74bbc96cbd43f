"""Batched fixed-shape beam search (the JAX package's ``decoding/beam.py``).

- finished beams may only continue with PAD at logprob 0, so their score
  is frozen while they still take part in the top-W;
- beam 0 alone is live at t=0 (the others start at -1e9), so the first
  expansion does not pick W copies of one token;
- one top-W over the flattened W*V candidates per step, value descending,
  ties toward the lower flat id (lower beam, then lower token), as
  ``lax.top_k``; parent beams are gathered for every piece of state.

Two implementations share that expansion (:func:`_topk_expand`):

- ``beam_impl="reference"``: beams flattened into the batch ([B*W] rows),
  one ``model.decode_step`` of the cell module per step;
- ``beam_impl="lanes"`` (default): one decode lane per beam, carry
  [W, B, ...]; at ``decode_impl="pallas"`` each step is ONE launch of the
  beam-step kernel (``ops/beam_step.py``: the decode step and the top-W
  selection), on a float32 carry it updates in place. The hypothesis
  reorder, a gather across lanes, runs between launches.

The early-exit loop stops once every beam of every row has finished: the
state is then a fixed point of the step (every continuation is PAD-only,
so the top-W reselects each beam in its current order), and the result is
that of the full T steps.
"""

from __future__ import annotations

import dataclasses

import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    forbid_special,
    lane_carry,
    lane_decode_step,
    row_logprobs,
    scan_until_finished,
)
from cst_captioning_tpu_torch.ops import beam_step as beam_ops
from cst_captioning_tpu_torch.ops.decode_stride import stride_weights

_NEG = -1.0e9

BEAM_IMPLS = ("lanes", "reference")


def _pad_row(V: int, device) -> torch.Tensor:
    """Continuation row of a finished beam: logp 0 at PAD, -1e9 else."""
    row = torch.full((V,), _NEG, device=device)
    row[PAD_ID] = 0.0
    return row


def _topk_expand(scores, finished, logp, pad_row, B: int, W: int, V: int):
    """(scores [B, W], finished [B, W], logp [B, W, V]) -> (top_scores
    [B, W], parent [B, W], tok [B, W] int32)."""
    cont = torch.where(finished[:, :, None], pad_row[None, None, :], logp)
    total = scores[:, :, None] + cont                           # [B, W, V]
    top_scores, flat = beam_ops.top_w(total.reshape(B, W * V), W)
    return top_scores, flat // V, (flat % V).to(torch.int32)


def _reorder(x: torch.Tensor, parent: torch.Tensor, axis: int):
    """x[..., w, b, ...] <- x[..., parent[b, w], b, ...], with the beam axis
    at ``axis`` and the batch axis after it."""
    idx = parent.T.reshape((1,) * axis + parent.T.shape
                           + (1,) * (x.ndim - axis - 2))
    return torch.gather(x, axis, idx.expand(x.shape))


def _state0(carry0, B: int, W: int, T: int, dev):
    """(carry, tokens, scores, finished, last): beam 0 alone live at t=0."""
    scores = torch.full((B, W), _NEG, device=dev)
    scores[:, 0] = 0.0
    return (
        carry0,
        torch.full((B, W, T), PAD_ID, dtype=torch.int32, device=dev),
        scores,
        torch.zeros((B, W), dtype=torch.bool, device=dev),
        torch.full((B, W), BOS_ID, dtype=torch.int32, device=dev),
    )


def _emit(tokens, finished, parent, tok, t: int):
    """Follow the parents, freeze finished beams to PAD, write step t."""
    tokens = torch.gather(tokens, 1, parent[:, :, None].expand(tokens.shape))
    finished = torch.gather(finished, 1, parent)
    tok = torch.where(finished, torch.full_like(tok, PAD_ID), tok)
    tokens[:, :, t] = tok
    return tokens, finished | (tok == EOS_ID), tok


def _run_reference(model, enc, B, V, W, T, min_len):
    """Beams flattened into the batch ([B*W] rows, beam-minor)."""
    tile = lambda x: x.repeat_interleave(W, dim=0)  # noqa: E731
    carry0 = tuple((tile(c), tile(h)) for c, h in enc.carry)
    enc_t = dataclasses.replace(
        enc, memory=tile(enc.memory), memory_proj=tile(enc.memory_proj),
        memory_mask=tile(enc.memory_mask), carry=())
    pad_row = _pad_row(V, enc.memory.device)
    rows = (torch.arange(B, device=enc.memory.device)[:, None] * W)

    def step(state, t):
        carry, tokens, scores, finished, last = state
        carry, logits = model.decode_step(carry, last.reshape(B * W).long(),
                                          enc_t)
        logits = apply_min_len(forbid_special(logits), t, min_len)
        logp = row_logprobs(logits).reshape(B, W, V)
        top_scores, parent, tok = _topk_expand(scores, finished, logp,
                                               pad_row, B, W, V)
        flat = (rows + parent).reshape(-1)
        carry = tuple((c[flat], h[flat]) for c, h in carry)
        tokens, finished, tok = _emit(tokens, finished, parent, tok, t)
        return (carry, tokens, top_scores, finished, tok), ()

    (_, tokens, scores, _, _), _ = scan_until_finished(
        step, _state0(carry0, B, W, T, enc.memory.device), T,
        lambda s: s[3], ())
    return tokens, scores


def _run_lanes(model, enc, B, V, W, T, min_len):
    """Beams on decode lanes: carry [W, B, ...], one lane per beam."""
    use_kernel = model.cfg.decode_impl == "pallas"
    dev = enc.memory.device
    carry0 = lane_carry(model, enc.carry, W)
    pad_row = _pad_row(V, dev)
    weights = logits_buf = None
    if use_kernel:
        # packed once per search, and the kernel's logits scratch
        weights = stride_weights(model.cell)
        logits_buf = torch.empty((W, B, V), dtype=torch.float32, device=dev)
    carry_dtype = enc.carry[0][0].dtype

    def step(state, t):
        carry, tokens, scores, finished, last = state  # last [W, B]
        if use_kernel:
            # the step and the top-W selection in one launch; the carry
            # [2, L, W, B, H] steps in place
            top_scores, flat = beam_ops.fused_beam_step_(
                model.cell, carry, last, finished.T, scores.T,
                enc.memory, enc.memory_proj, enc.memory_mask, carry_dtype,
                t=t, min_len=min_len, num_layers=model.cfg.num_layers,
                weights=weights, logits=logits_buf)
            flat = flat.long()
            parent, tok = flat // V, (flat % V).to(torch.int32)
            carry = _reorder(carry, parent, 2)
        else:
            carry, logits = lane_decode_step(model, carry, last, enc)
            logits = apply_min_len(forbid_special(logits), t, min_len)
            logp = row_logprobs(logits).transpose(0, 1)           # [B, W, V]
            top_scores, parent, tok = _topk_expand(scores, finished, logp,
                                                   pad_row, B, W, V)
            carry = tuple((_reorder(c, parent, 0), _reorder(h, parent, 0))
                          for c, h in carry)
        tokens, finished, tok = _emit(tokens, finished, parent, tok, t)
        return (carry, tokens, top_scores, finished, tok.T.contiguous()), ()

    carry, tokens, scores, finished, last = _state0(carry0, B, W, T, dev)
    (_, tokens, scores, _, _), _ = scan_until_finished(
        step, (carry, tokens, scores, finished, last.T.contiguous()), T,
        lambda s: s[3], ())
    return tokens, scores


@torch.no_grad()
def beam_search(model, feats, masks, beam_size: int = 5,
                max_len: int | None = None, min_len: int = 0,
                length_penalty: float = 0.0, return_all: bool = False,
                beam_impl: str = "lanes"):
    """-> (tokens [B, T] int32, scores [B] float32), or every beam ranked,
    [B, W, T] / [B, W], with ``return_all``. ``length_penalty`` a rescales
    the final scores by ``1 / len^a`` (0: the pure sum-logprob ranking)."""
    if beam_impl not in BEAM_IMPLS:
        raise ValueError(
            f"beam_impl must be one of {BEAM_IMPLS}, got {beam_impl!r}")
    W = beam_size
    T = max_len or model.cfg.max_len
    enc = model.encode(feats, masks)
    B = enc.memory.shape[0]
    V = model.cfg.vocab_size
    run = _run_lanes if beam_impl == "lanes" else _run_reference
    tokens, scores = run(model, enc, B, V, W, T, min_len)
    if length_penalty > 0.0:
        lengths = (tokens != PAD_ID).sum(dim=-1).clamp(min=1).float()
        ranked = scores / lengths ** length_penalty
    else:
        ranked = scores
    if return_all:
        _, order = torch.sort(-ranked, dim=1, stable=True)
        return (torch.gather(tokens, 1, order[:, :, None].expand(tokens.shape)),
                torch.gather(ranked, 1, order))
    best = torch.argmax(ranked, dim=1)                          # [B]
    best_tokens = torch.gather(
        tokens, 1, best[:, None, None].expand(B, 1, T))[:, 0]
    return best_tokens, torch.gather(ranked, 1, best[:, None])[:, 0]
