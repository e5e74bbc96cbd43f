"""Shared decode plumbing: logprob selection, special-token masking, frozen
post-EOS outputs, the NPAD lane pick and answer, the lane-batched decode
step, the early-exit decode loop, and the counter-based Gumbel noise the
serving engine and the RL rollouts sample with."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.ops import decode_step as decode_step_ops


def selected_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Logprob of ``token`` under softmax(logits): [..., V], [...] -> [...],
    as ``logit - logsumexp(logits)`` on the selected column only."""
    lse = torch.logsumexp(logits, dim=-1)
    sel = torch.gather(logits, -1, token.long().unsqueeze(-1)).squeeze(-1)
    return sel - lse


def row_logprobs(logits: torch.Tensor) -> torch.Tensor:
    """Full log-softmax row in the :func:`selected_logprob` association
    (``x - logsumexp(x)``), so a gathered column equals it bit for bit."""
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def npad_best_lane_index(logprobs):
    """[G, .., T] per-token logprobs -> [..] best lane per row (NPAD pick:
    highest sum-logprob lane; ties go to the lowest lane, so the answer is
    never below greedy lane 0). Works on numpy arrays and tensors."""
    return logprobs.sum(axis=-1).argmax(axis=0)


def npad_best_lane(tokens: torch.Tensor, logprobs: torch.Tensor):
    """The NPAD answer: ([G, B, T], [G, B, T]) -> (the best lane's tokens
    [B, T], its sum-logprob score [B]), gathered on the tensors' device."""
    best = npad_best_lane_index(logprobs)                         # [B]
    T = tokens.shape[-1]
    best_tokens = torch.gather(
        tokens, 0, best[None, :, None].expand(1, -1, T))[0]
    best_scores = torch.gather(logprobs.sum(dim=-1), 0, best[None])[0]
    return best_tokens, best_scores


def forbid_special(logits: torch.Tensor) -> torch.Tensor:
    """PAD and BOS columns -> -1e9: decoders may only end a caption by EOS."""
    out = logits.clone()
    out[..., PAD_ID] = -1.0e9
    out[..., BOS_ID] = -1.0e9
    return out


def step_outputs(token: torch.Tensor, logprob: torch.Tensor,
                 finished: torch.Tensor):
    """Force PAD / zero logprob after EOS -> (token, logprob, finished')."""
    token = torch.where(finished, torch.full_like(token, PAD_ID), token)
    logprob = torch.where(finished, torch.zeros_like(logprob), logprob)
    return token, logprob, finished | (token == EOS_ID)


def mask_from_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """[.., T] decoded tokens -> float mask counting real tokens incl. EOS."""
    return (tokens != PAD_ID).float()


def apply_min_len(logits: torch.Tensor, t: int, min_len: int) -> torch.Tensor:
    """EOS -> -1e9 while step ``t`` < ``min_len`` (no empty captions)."""
    if min_len <= 0 or t >= min_len:
        return logits
    out = logits.clone()
    out[..., EOS_ID] = -1.0e9
    return out


def lane_carry(model, carry, G: int):
    """The decode loop's carry for G lanes from the encoder's L x (c, h)
    [B, H]: for ``decode_impl == "pallas"`` the decode-step kernel's float32
    [2, L, G, B, H] tensor, which each step updates in place; for ``"xla"``
    L x (c, h) [G, B, H]."""
    lanes = tuple((c[None].expand(G, -1, -1), h[None].expand(G, -1, -1))
                  for c, h in carry)
    if model.cfg.decode_impl == "pallas":
        return decode_step_ops.stack_carry(lanes)
    return lanes


def lane_decode_step(model, carry, token, enc, weights=None):
    """One decoder step over a lane-batched state: [G, B, ...] -> [G, B, V].

    Every lane reads the same encoder output; ``carry`` is the loop's carry
    from :func:`lane_carry`. ``decode_impl == "pallas"`` calls
    ``ops.decode_step.fused_decode_step_`` (the decode-step kernel on the
    GPU; ``weights`` are its packed float32 weights), which steps the carry
    in place, rounded to the encoder carry's dtype; ``"xla"`` steps the cell
    module lane by lane."""
    if model.cfg.decode_impl == "pallas":
        logits = decode_step_ops.fused_decode_step_(
            model.cell, carry, token, enc.memory, enc.memory_proj,
            enc.memory_mask, enc.carry[0][0].dtype,
            num_layers=model.cfg.num_layers, weights=weights)
        return carry, logits
    outs = [model.decode_step(tuple((c[g], h[g]) for c, h in carry),
                              token[g].long(), enc)
            for g in range(token.shape[0])]
    new_carry = tuple(
        (torch.stack([o[0][i][0] for o in outs]),
         torch.stack([o[0][i][1] for o in outs]))
        for i in range(len(carry)))
    return new_carry, torch.stack([o[1] for o in outs])


def _exit_stride(length: int) -> int:
    """Steps per exit check: a divisor of ``length`` near 5 when one
    exists (each check is a device-to-host read)."""
    for c in (5, 6, 4, 3, 7, 2):
        if length % c == 0:
            return c
    return min(4, length)


def scan_until_finished(step, init, length: int, get_finished, y_fills):
    """Run ``step(state, t)`` for t = 0, 1, .. < ``length``, checking every
    ``_exit_stride(length)`` steps whether every row has finished and
    stopping then. -> (final state, ys stacked on axis 0 with ``length``
    rows; rows never run hold ``y_fills``). As in the JAX loop, the steps
    of finished rows emit exactly the fills, so the early exit returns the
    ys of the full loop; the final state is not covered by that."""
    stride = _exit_stride(length)
    state, ys, t = init, [], 0
    while t < length and bool((~get_finished(state)).any()):
        for _ in range(min(stride, length - t)):
            state, y = step(state, t)
            ys.append(y)
            t += 1
    out = []
    for i, fill in enumerate(y_fills):
        col = [y[i] for y in ys]
        col += [torch.full_like(col[0], fill)] * (length - t)
        out.append(torch.stack(col))
    return state, tuple(out)


def decode_depth(tokens, length: int, stride: int | None = None) -> int:
    """Steps the early-exit loop ran to decode ``tokens`` [.., T]: the next
    multiple of the loop's stride (the exit stride of the per-step loop,
    or the fused decode's ``stride``) at or above the longest row (EOS
    included), capped at ``length``."""
    stride = stride or _exit_stride(length)
    longest = max(int((tokens != PAD_ID).sum(-1).max()), 1)
    return min(length, stride * -(-longest // stride))


# ---- counter-based Gumbel noise ---------------------------------------------
#
# The sampled lanes select argmax(logits / T + gumbel). The noise is a pure
# function of (request seed, lane k, the request's local step t, token v):
# a 32-bit integer hash chain in int64 torch ops that never overflow (each
# 32x32-bit product is split into 16-bit halves), so the hash bits are the
# same on the CPU and the GPU, and a request's draws do not depend on its
# lane or its batch-mates. The uniform keeps 24 bits; the Gumbel transform
# runs in float64 and rounds once to float32, so the two devices agree bit
# for bit unless their float64 logs differ across a float32 rounding
# boundary (chip_smoke.py counts such draws).

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 finalizer: a bijection on 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_gumbel_noise(seeds: torch.Tensor, ts: torch.Tensor, K: int,
                         V: int) -> torch.Tensor:
    """``seeds`` [B] and local steps ``ts`` [S, B] (int64) -> Gumbel noise
    [S, K, B, V] float32 on their device."""
    dev = seeds.device
    x = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)[None, None, :, None]
    k = torch.arange(K, device=dev, dtype=torch.int64)[None, :, None, None]
    x = _mix32(x ^ _mix32(k + 0x632BE5AB))
    x = _mix32(x ^ _mix32(ts.long()[:, None, :, None] + 0x85EBCA77))
    v = torch.arange(V, device=dev, dtype=torch.int64)[None, None, None, :]
    x = _mix32(x ^ _mix32(v + 0xC2B2AE3D))
    u = ((x >> 8).to(torch.float64) + 0.5) * np.float64(2.0 ** -24)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def rollout_noise(seed: int, K: int, B: int, V: int, device,
                  row_offset: int = 0) -> Callable[[int], torch.Tensor]:
    """The RL rollouts' Gumbel noise: step ``t`` -> [K, B, V] float32, a
    counter hash of (step seed, row b, rollout k, step t, token v), drawn
    in the batch's own row order. ``row_offset`` is the global index of
    row 0: a data-parallel rank holding rows ``offset..offset+B`` of the
    global batch draws their noise, so sharded rollouts equal unsharded
    ones."""
    dev = torch.device(device)
    rows = torch.arange(row_offset, row_offset + B, device=dev,
                        dtype=torch.int64)
    seeds = _mix32((int(seed) & _M32) ^ _mix32(rows + 0x165667B1))

    def noise(t: int) -> torch.Tensor:
        ts = torch.full((1, B), int(t), device=dev, dtype=torch.int64)
        return counter_gumbel_noise(seeds, ts, K, V)[0]

    return noise
