"""Greedy decoding (the JAX package's ``decoding/greedy.py``): the eval's
``beam_size=1`` path and the two-loop SCST baseline.

The lane-batched decode step runs as a single lane (G=1), so its numerics
are the sampling and fused loops' own: the decode-step kernel at
``decode_impl="pallas"`` (a carry it updates in place), the cell module at
``"xla"``. The early-exit loop stops once every row has emitted EOS.
"""

from __future__ import annotations

import torch

from cst_captioning_tpu_torch.config import BOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    forbid_special,
    lane_carry,
    lane_decode_step,
    scan_until_finished,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.ops.decode_stride import stride_weights


@torch.no_grad()
def greedy_decode(model, feats, masks, max_len: int | None = None,
                  min_len: int = 0):
    """-> (tokens [B, T] int32, logprobs [B, T] float32); PAD/0 after EOS."""
    cfg = model.cfg
    T = max_len or cfg.max_len
    enc = model.encode(feats, masks)
    B = enc.memory.shape[0]
    weights = stride_weights(model.cell) if cfg.decode_impl == "pallas" \
        else None

    def step(state, t):
        carry, token, finished = state
        carry, logits = lane_decode_step(model, carry, token, enc, weights)
        logits = apply_min_len(forbid_special(logits), t, min_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        lp = selected_logprob(logits, nxt)
        nxt, lp, finished = step_outputs(nxt, lp, finished)
        return (carry, nxt, finished), (nxt, lp)

    dev = enc.memory.device
    init = (
        lane_carry(model, enc.carry, 1),
        torch.full((1, B), BOS_ID, dtype=torch.int32, device=dev),
        torch.zeros((1, B), dtype=torch.bool, device=dev),
    )
    _, (tokens, logprobs) = scan_until_finished(
        step, init, T, lambda s: s[2], (PAD_ID, 0.0))
    # ys stack on axis 0: [T, 1, B] -> [B, T]
    return tokens[:, 0].T.contiguous(), logprobs[:, 0].T.contiguous()
