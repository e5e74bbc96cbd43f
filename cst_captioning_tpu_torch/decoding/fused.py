"""The one-loop RL decode: the greedy baseline and K rollouts together (the
JAX package's ``decoding/fused.py``).

Lane 0 takes the argmax of its untempered logits; lanes 1..K select
``argmax(logits / temperature + noise)`` with Gumbel noise drawn in the
batch's ORIGINAL column order (``rollout_noise(seed)``, or ``noise_fn(t)
-> [K, B, V]``, through which the parity tests feed the JAX draws). One
encoder pass feeds every lane; the loop stops once every lane of every
clip has emitted EOS.

``ModelConfig.decode_stride`` / ``decode_compact`` shape the loop:

- stride S: each turn of the loop advances S steps. At
  ``decode_impl="pallas"`` a turn is ONE launch of the stride kernel
  (``ops/decode_stride.py``: selection and the next token's embedding in
  the kernel); at ``"xla"`` it is S steps of the cell module.
- compaction: between turns, columns whose every lane has finished move
  behind the still-active ones (a stable argsort, so active columns keep
  their order), the stride steps the permuted state (the kernel skips the
  rows past the active prefix), and the outputs scatter back through the
  inverse permutation. The noise is gathered through the same
  permutation, so a clip keeps its stream wherever compaction moves it.

Stride 1 without compaction is the per-step loop (the decode-step kernel
at ``"pallas"``), which every other combination matches token for token.
"""

from __future__ import annotations

from typing import Callable

import torch

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    forbid_special,
    lane_carry,
    lane_decode_step,
    npad_best_lane,
    rollout_noise,
    scan_until_finished,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    fused_decode_stride,
    stride_weights,
)

NoiseFn = Callable[[int], torch.Tensor]


def _sel_step(model, enc, draw: NoiseFn, temperature: float, min_len: int,
              perm, weights):
    """The (1+K)-lane step with token selection; ``perm`` (or None) maps
    the state's columns to original batch order for the noise."""

    def step(state, t):
        carry, token, finished = state
        carry, logits = lane_decode_step(model, carry, token, enc, weights)
        logits = apply_min_len(forbid_special(logits), t, min_len)
        g_nxt = torch.argmax(logits[0], dim=-1)
        tl = logits[1:] / temperature
        noise = draw(t).to(tl.device)
        if perm is not None:
            noise = noise[:, perm, :]
        s_nxt = torch.argmax(tl + noise, dim=-1)
        nxt = torch.cat([g_nxt[None], s_nxt]).to(torch.int32)
        lp = selected_logprob(logits, nxt)
        nxt, lp, finished = step_outputs(nxt, lp, finished)
        return (carry, nxt, finished), (nxt, lp)

    return step


def _stride_decode(model, enc, draw: NoiseFn, T: int, S: int, K: int,
                   temperature: float, min_len: int, compact: bool, weights):
    """The strided loop (module docstring) -> (tokens [T, 1+K, B],
    logprobs [T, 1+K, B])."""
    cfg = model.cfg
    G = 1 + K
    B = enc.memory.shape[0]
    dev = enc.memory.device
    padded = -(-T // S) * S
    use_kernel = cfg.decode_impl == "pallas"
    carry = tuple((c[None].expand(G, -1, -1), h[None].expand(G, -1, -1))
                  for c, h in enc.carry)
    token = torch.full((G, B), BOS_ID, dtype=torch.int32, device=dev)
    finished = torch.zeros((G, B), dtype=torch.bool, device=dev)
    tok_buf = torch.full((padded, G, B), PAD_ID, dtype=torch.int32,
                         device=dev)
    lp_buf = torch.zeros((padded, G, B), dtype=torch.float32, device=dev)
    t = 0
    while t < T and bool((~finished).any()):
        perm = inv = None
        n_active = B
        enc_c = enc
        if compact:
            col_done = finished.all(dim=0)
            perm = torch.argsort(col_done.to(torch.int8), stable=True)
            inv = torch.argsort(perm, stable=True)
            n_active = B - int(col_done.sum())
            carry = tuple((c[:, perm], h[:, perm]) for c, h in carry)
            token, finished = token[:, perm], finished[:, perm]
            enc_c = enc.take_batch(perm)
        if use_kernel:
            # the stride's noise in original column order; steps past T
            # draw step T-1's (their emissions are sliced off)
            noise = torch.stack([draw(t + s) for s in range(S)]).to(dev)
            if compact:
                noise = noise[:, :, perm, :]
            carry, tok_c, lp_c = fused_decode_stride(
                model.cell, carry, token, finished, enc_c.memory,
                enc_c.memory_proj, enc_c.memory_mask, noise.contiguous(), t,
                n_active, steps=S, temperature=temperature, min_len=min_len,
                num_layers=cfg.num_layers, weights=weights)
            # the kernel emits the frozen-token stream: the carried token is
            # its last emission, finished takes any EOS of the stride
            token = tok_c[-1]
            finished = finished | (tok_c == EOS_ID).any(dim=0)
        else:
            step = _sel_step(model, enc_c, draw, temperature, min_len, perm,
                             None)
            state, ys = (carry, token, finished), []
            for s in range(S):
                state, y = step(state, t + s)
                ys.append(y)
            carry, token, finished = state
            tok_c = torch.stack([y[0] for y in ys])
            lp_c = torch.stack([y[1] for y in ys])
        if compact:
            carry = tuple((c[:, inv], h[:, inv]) for c, h in carry)
            token, finished = token[:, inv], finished[:, inv]
            tok_c, lp_c = tok_c[:, :, inv], lp_c[:, :, inv]
        tok_buf[t:t + S] = tok_c
        lp_buf[t:t + S] = lp_c
        t += S
    return tok_buf[:T], lp_buf[:T]


@torch.no_grad()
def fused_decode(model, feats, masks, seed: int = 0, num_rollouts: int = 1,
                 temperature: float = 1.0, max_len: int | None = None,
                 min_len: int = 0, decode_stride: int | None = None,
                 compact: bool | None = None,
                 noise_fn: NoiseFn | None = None, row_offset: int = 0):
    """-> (greedy [B, T], greedy_lp [B, T], tokens [K, B, T], logprobs
    [K, B, T]); int32 tokens, float32 untempered model logprobs of the
    chosen tokens, PAD/0 after EOS on every lane. ``decode_stride`` and
    ``compact`` default from ``model.cfg``; ``row_offset`` is the global
    index of row 0 for the noise (``rollout_noise``)."""
    cfg = model.cfg
    T = max_len or cfg.max_len
    K = num_rollouts
    S = decode_stride if decode_stride is not None else cfg.decode_stride
    S = max(1, min(int(S), T))
    if compact is None:
        compact = bool(cfg.decode_compact)
    if S == 1:
        # compaction pays only between strides: stride 1 is the per-step
        # loop
        compact = False
    enc = model.encode(feats, masks)
    B = enc.memory.shape[0]
    if noise_fn is None:
        noise_fn = rollout_noise(seed, K, B, cfg.vocab_size,
                                 enc.memory.device, row_offset)
    draw = lambda t: noise_fn(min(t, T - 1))  # noqa: E731
    # the kernels' float32 weights, packed once for the whole decode
    weights = stride_weights(model.cell) if cfg.decode_impl == "pallas" \
        else None
    if S == 1:
        dev = enc.memory.device
        init = (
            lane_carry(model, enc.carry, 1 + K),
            torch.full((1 + K, B), BOS_ID, dtype=torch.int32, device=dev),
            torch.zeros((1 + K, B), dtype=torch.bool, device=dev),
        )
        step = _sel_step(model, enc, draw, temperature, min_len, None,
                         weights)
        _, (tokens, logprobs) = scan_until_finished(
            step, init, T, lambda s: s[2], (PAD_ID, 0.0))
    else:
        tokens, logprobs = _stride_decode(model, enc, draw, T, S, K,
                                          temperature, min_len, compact,
                                          weights)
    # [T, 1+K, B] -> [1+K, B, T]
    tokens = tokens.permute(1, 2, 0).contiguous()
    logprobs = logprobs.permute(1, 2, 0).contiguous()
    return tokens[0], logprobs[0], tokens[1:], logprobs[1:]


def npad_decode(model, feats, masks, seed: int = 0, num_lanes: int = 4,
                temperature: float = 1.0, max_len: int | None = None,
                min_len: int = 0, decode_stride: int | None = None,
                compact: bool | None = None,
                noise_fn: NoiseFn | None = None, row_offset: int = 0):
    """Noisy Parallel Approximate Decoding -> (tokens [B, T], scores [B]):
    the greedy lane and ``num_lanes`` noise-perturbed lanes decode together
    and the highest sum-logprob lane answers (ties toward the greedy lane,
    so the answer is never below greedy)."""
    g_tok, g_lp, s_tok, s_lp = fused_decode(
        model, feats, masks, seed, num_rollouts=num_lanes,
        temperature=temperature, max_len=max_len, min_len=min_len,
        decode_stride=decode_stride, compact=compact, noise_fn=noise_fn,
        row_offset=row_offset)
    tokens = torch.cat([g_tok[None], s_tok])                  # [1+M, B, T]
    logprobs = torch.cat([g_lp[None], s_lp])
    return npad_best_lane(tokens, logprobs)
