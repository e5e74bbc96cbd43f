"""Multinomial sampling with K rollouts per clip (the JAX package's
``decoding/sample.py``).

One encoder pass is shared by the K rollouts; the K x B rows step together
through ``lane_decode_step`` (the decode-step kernel at
``decode_impl="pallas"``, on a carry it updates in place) in the early-exit
loop, which stops once every
rollout of every clip has emitted EOS. Rollout k at step t selects
``argmax(logits / temperature + noise)`` with Gumbel noise from
``rollout_noise(seed)``, a counter hash drawn in the batch's row order;
``noise_fn(t) -> [K, B, V]`` replaces it (the parity tests feed the JAX
sampler's own draws through it).
"""

from __future__ import annotations

from typing import Callable

import torch

from cst_captioning_tpu_torch.config import BOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    forbid_special,
    lane_carry,
    lane_decode_step,
    rollout_noise,
    scan_until_finished,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.ops.decode_stride import stride_weights


@torch.no_grad()
def sample_decode(model, feats, masks, seed: int = 0, num_rollouts: int = 1,
                  temperature: float = 1.0, max_len: int | None = None,
                  min_len: int = 0,
                  noise_fn: Callable[[int], torch.Tensor] | None = None,
                  row_offset: int = 0):
    """-> (tokens [K, B, T] int32, logprobs [K, B, T] float32); PAD/0 after
    EOS. ``logprobs`` are the untempered model logprobs of the sampled
    tokens (REINFORCE needs log p_model). ``row_offset``: the global index
    of row 0 for the noise (``rollout_noise``)."""
    cfg = model.cfg
    T = max_len or cfg.max_len
    K = num_rollouts
    enc = model.encode(feats, masks)
    B = enc.memory.shape[0]
    if noise_fn is None:
        noise_fn = rollout_noise(seed, K, B, cfg.vocab_size,
                                 enc.memory.device, row_offset)
    # the kernel's float32 weights, packed once for the whole loop
    weights = stride_weights(model.cell) if cfg.decode_impl == "pallas" \
        else None

    def step(state, t):
        carry, token, finished = state
        carry, logits = lane_decode_step(model, carry, token, enc, weights)
        logits = apply_min_len(forbid_special(logits), t, min_len)
        tl = logits / temperature
        nxt = torch.argmax(tl + noise_fn(t).to(tl.device), dim=-1).to(torch.int32)
        lp = selected_logprob(logits, nxt)
        nxt, lp, finished = step_outputs(nxt, lp, finished)
        return (carry, nxt, finished), (nxt, lp)

    dev = enc.memory.device
    init = (
        lane_carry(model, enc.carry, K),
        torch.full((K, B), BOS_ID, dtype=torch.int32, device=dev),
        torch.zeros((K, B), dtype=torch.bool, device=dev),
    )
    _, (tokens, logprobs) = scan_until_finished(
        step, init, T, lambda s: s[2], (PAD_ID, 0.0))
    # ys stack on axis 0: [T, K, B] -> [K, B, T]
    return tokens.permute(1, 2, 0).contiguous(), \
        logprobs.permute(1, 2, 0).contiguous()
