"""The sequential CST step: rollout decode -> host consensus reward ->
REINFORCE update (the JAX package's ``rl/scst.py``).

1. :func:`make_rl_decode`: K multinomial rollouts per clip. The "greedy"
   baseline (SCST) decodes the greedy rollout with them in one loop
   (``decoding/fused.py``: lane 0 greedy, one stride-kernel launch per
   stride at ``decode_impl="pallas"``); the "scb" and "none" baselines
   need no greedy rollout and sample through ``sample_decode`` (the
   decode-step kernel at ``decode_impl="pallas"``).
2. Host: ``RewardComputer`` scores the rollouts (and the greedy rollout)
   against the consensus pools; advantage = reward - baseline.
3. :func:`make_rl_update`: teacher-forces the sampled tokens through the
   model (the additive-attention kernel at ``attention_impl="pallas"``) for
   differentiable logprobs, with one encoder pass per clip tiled over the
   rollouts, and applies the REINFORCE gradient.

Not carried from the JAX trainer: the pipelined ``train_epoch``, meshes,
reward retries and chaos hooks, and the obs spans and counters.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from cst_captioning_tpu_torch.config import RLConfig
from cst_captioning_tpu_torch.decoding.common import (
    decode_depth,
    mask_from_tokens,
)
from cst_captioning_tpu_torch.decoding.fused import fused_decode
from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
from cst_captioning_tpu_torch.decoding.sample import sample_decode
from cst_captioning_tpu_torch.losses import reinforce_loss
from cst_captioning_tpu_torch.models.captioner import EncoderOutput
from cst_captioning_tpu_torch.rl.rewards import scb_baseline
from cst_captioning_tpu_torch.train.schedule import global_norm
from cst_captioning_tpu_torch.train.state import TrainState
from cst_captioning_tpu_torch.train.steps import _apply


def make_rl_decode(model, num_rollouts: int, temperature: float = 1.0,
                   max_len: int | None = None, with_greedy: bool = True,
                   fused: bool = True) -> Callable:
    """-> decode(model, feats, masks, seed, noise_fn=None) -> (greedy
    [B, T] or None, samples [K, B, T]) int32, decoding with the parameters
    of the ``model`` passed to ``decode`` (the JAX decode's ``params``; the
    training state's model). ``noise_fn(t) -> [K, B, V]`` replaces the
    rollouts' Gumbel noise.

    ``with_greedy`` and ``fused``: one loop gives greedy lane 0 and the K
    rollouts (``fused_decode``); ``fused=False`` runs ``greedy_decode``
    and then ``sample_decode``, the two-loop reference. Without
    ``with_greedy`` (the scb and none baselines) ``greedy`` is None."""
    del model  # the decode call names the model that holds the params

    def decode(model, feats, masks, seed: int, noise_fn=None):
        if with_greedy and fused:
            greedy, _, samples, _ = fused_decode(
                model, feats, masks, seed, num_rollouts=num_rollouts,
                temperature=temperature, max_len=max_len, noise_fn=noise_fn)
            return greedy, samples
        greedy = None
        if with_greedy:
            greedy, _ = greedy_decode(model, feats, masks, max_len=max_len)
        samples, _ = sample_decode(
            model, feats, masks, seed, num_rollouts=num_rollouts,
            temperature=temperature, max_len=max_len, noise_fn=noise_fn)
        return greedy, samples

    return decode


def _tile_enc(enc: EncoderOutput, K: int) -> EncoderOutput:
    """EncoderOutput [B, ...] -> [K*B, ...], rollout-major to match
    ``samples.reshape(K * B, T)``; gradients flow back as the sum over
    the K copies."""
    t = lambda x: x.repeat((K,) + (1,) * (x.ndim - 1))  # noqa: E731
    return EncoderOutput(t(enc.memory), t(enc.memory_proj),
                         t(enc.memory_mask),
                         tuple((t(c), t(h)) for c, h in enc.carry))


def _decode_loss_sums(model, enc_tiled, tokens_flat, advantage_flat,
                      valid_tiled):
    """(numerator, denominator) REINFORCE sums from a tiled encoder output;
    ``valid_tiled`` zeroes wrap-padded rows. The teacher-forced logprobs
    never build the [rows, T, V] logits stack."""
    logp = model.teacher_force_logps(enc_tiled, tokens_flat)
    mask = mask_from_tokens(tokens_flat) * valid_tiled[:, None]
    den = mask.sum()
    num = reinforce_loss(logp, mask, advantage_flat) * torch.clamp(den, min=1.0)
    return num, den


def _enc_leaves(enc: EncoderOutput) -> list[torch.Tensor]:
    return [enc.memory, enc.memory_proj, enc.memory_mask,
            *(x for layer in enc.carry for x in layer)]


def _enc_from_leaves(leaves) -> EncoderOutput:
    carry = tuple((leaves[i], leaves[i + 1]) for i in range(3, len(leaves), 2))
    return EncoderOutput(leaves[0], leaves[1], leaves[2], carry)


def _chunked_loss_grads(model, params, feats, masks, samples, advantage,
                        valid, chunks: int):
    """REINFORCE sums and gradients accumulated over ``chunks`` slices of
    the K rollout axis, with one encoder pass shared by every chunk: each
    chunk differentiates the decode w.r.t. (params, encoder output), the
    encoder-output gradients accumulate in float32, and one backward
    through the encoder at the end folds them into the parameters."""
    K, B, T = samples.shape
    if K % chunks:
        raise ValueError(f"update_chunks {chunks} must divide K={K} rollouts")
    kc = K // chunks
    leaves = _enc_leaves(model.encode(feats, masks))
    cut = [x.detach().requires_grad_(x.requires_grad) for x in leaves]
    diff = [i for i, x in enumerate(cut) if x.requires_grad]
    enc = _enc_from_leaves(cut)
    valid_f = valid.repeat(kc)
    sam = samples.reshape(chunks, kc * B, T)
    adv = advantage.reshape(chunks, kc * B)
    gp = [torch.zeros_like(p) for p in params]
    ge = [torch.zeros(cut[i].shape, dtype=torch.float32, device=cut[i].device)
          for i in diff]
    num = torch.zeros((), device=samples.device)
    den = torch.zeros((), device=samples.device)
    for c in range(chunks):
        n_c, d_c = _decode_loss_sums(model, _tile_enc(enc, kc), sam[c], adv[c],
                                     valid_f)
        g = torch.autograd.grad(n_c, params + [cut[i] for i in diff],
                                allow_unused=True)
        gp = [a if b is None else a + b for a, b in zip(gp, g[:len(params)])]
        ge = [a + b.float() for a, b in zip(ge, g[len(params):])]
        num = num + n_c.detach()
        den = den + d_c
    # one backward through the encoder, in the encoder output's dtypes
    g_enc = torch.autograd.grad(
        [leaves[i] for i in diff], params,
        grad_outputs=[e.to(leaves[i].dtype) for e, i in zip(ge, diff)],
        allow_unused=True)
    g_sum = [a if b is None else a + b for a, b in zip(gp, g_enc)]
    return num, den, g_sum


def make_rl_update(model, chunks: int = 1, guard: bool = False) -> Callable:
    """-> update(state, feats, masks, samples [K, B, T], advantage [K, B],
    valid [B]) -> (state, metrics). ``chunks > 1`` accumulates the gradient
    over slices of the rollout axis (the same total gradient up to float
    summation order). The state's model is updated in place."""
    del model  # the state carries it; kept for the JAX factory's signature

    def update(state: TrainState, feats, masks, samples, advantage, valid):
        model = state.model
        params = state.params
        if chunks > 1:
            num, den, g_sum = _chunked_loss_grads(
                model, params, feats, masks, samples, advantage, valid, chunks)
            den = torch.clamp(den, min=1.0)
            loss = num / den
            grads = [g / den for g in g_sum]
        else:
            K, B, T = samples.shape
            enc = model.encode(feats, masks)
            num, den = _decode_loss_sums(
                model, _tile_enc(enc, K), samples.reshape(K * B, T),
                advantage.reshape(K * B), valid.repeat(K))
            loss = num / torch.clamp(den, min=1.0)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
        return _apply(state, grads, loss, global_norm(grads), guard,
                      key="rl_loss")

    return update


class SCSTTrainer:
    """Per-batch CST step: decode -> consensus reward -> REINFORCE update.

    ``baseline``: 'greedy' (SCST: the greedy rollout's reward), 'scb'
    (self-consensus across the other K-1 rollouts, CST_MS_SCB) or 'none'.
    ``guard=True`` adds the finite-update guard. The metrics carry the
    phase times in seconds (``decode_s`` up to the tokens on the host,
    ``reward_s``, ``update_s`` up to the loss on the host) and
    ``decode_steps``, the steps the early-exit loop ran (a multiple of the
    decode stride on the greedy baseline's strided loop).
    """

    def __init__(self, model, reward, cfg: RLConfig,
                 max_len: int | None = None, guard: bool = False):
        self.model = model
        self.reward = reward
        self.cfg = cfg
        self.max_len = max_len or model.cfg.max_len
        self.decode = make_rl_decode(
            model, cfg.num_rollouts, cfg.temperature, max_len,
            with_greedy=cfg.baseline == "greedy")
        # the loop's stride: the fused decode's, or the per-step exit check
        stride = max(1, min(model.cfg.decode_stride, self.max_len))
        self._stride = stride if cfg.baseline == "greedy" and stride > 1 \
            else None
        self.update = make_rl_update(model, chunks=cfg.update_chunks,
                                     guard=guard)

    # ---- reward / advantage (host) ------------------------------------------

    def _advantage(self, greedy, samples_np, video_ids, valid_np):
        """-> (advantage [K, B] np, metrics dict)."""
        K = self.cfg.num_rollouts
        B = samples_np.shape[1]
        r_samples = self.reward(video_ids, samples_np.reshape(K * B, -1))
        r_kb = r_samples.reshape(K, B)

        if self.cfg.baseline == "greedy":
            if greedy is None:
                raise ValueError(
                    "baseline='greedy' needs the greedy rollout; the decode "
                    "was built with with_greedy=False")
            r_greedy = self.reward(video_ids, np.asarray(greedy))
            baseline = np.broadcast_to(r_greedy[None, :], (K, B))
        elif self.cfg.baseline == "scb":
            baseline = scb_baseline(r_kb)
        elif self.cfg.baseline == "none":
            baseline = np.zeros_like(r_kb)
        else:
            raise ValueError(f"unknown baseline {self.cfg.baseline!r}")

        advantage = (r_kb - baseline) * valid_np[None, :]
        n_valid = max(valid_np.sum(), 1.0)
        v = valid_np[None, :]
        r_valid = r_kb[:, valid_np > 0]
        a_valid = advantage[:, valid_np > 0]
        has_valid = valid_np.sum() > 0
        metrics = {
            "reward_mean": float((r_kb * v).sum() / (K * n_valid)),
            "reward_std": float(r_valid.std()) if has_valid else 0.0,
            "reward_p10": (
                float(np.percentile(r_valid, 10.0)) if has_valid else 0.0
            ),
            "reward_p90": (
                float(np.percentile(r_valid, 90.0)) if has_valid else 0.0
            ),
            "baseline_mean": float(
                (np.asarray(baseline) * v).sum() / (K * n_valid)),
            "advantage_mean": float(advantage.sum() / (K * n_valid)),
            "advantage_std": float(a_valid.std()) if has_valid else 0.0,
            "valid_rows": float(valid_np.sum()),
        }
        return advantage, metrics

    def _score(self, greedy, samples, feats, masks, video_ids, valid_np):
        """Host half: read the tokens back and compute the advantage ->
        the argument tuple of :meth:`_apply`."""
        samples_np = samples.cpu().numpy()
        greedy_np = None if greedy is None else greedy.cpu().numpy()
        t = time.perf_counter()
        advantage, host_metrics = self._advantage(
            greedy_np, samples_np, video_ids, valid_np)
        host_metrics["reward_s"] = time.perf_counter() - t
        return advantage, host_metrics, samples, feats, masks, valid_np

    def _apply(self, state, advantage, host_metrics, samples, feats, masks,
               valid_np):
        """Device half: upload the advantage, run the REINFORCE update."""
        dev = samples.device
        adv = torch.from_numpy(np.asarray(advantage, np.float32)).to(dev)
        valid = torch.from_numpy(np.asarray(valid_np, np.float32)).to(dev)
        state, metrics = self.update(state, feats, masks, samples, adv, valid)
        metrics.update(host_metrics)
        return state, metrics

    @staticmethod
    def _valid_np(valid, B):
        return (np.ones((B,), np.float32) if valid is None
                else np.asarray(valid, np.float32))

    # ---- strict sequential step ---------------------------------------------

    def train_step(self, state: TrainState, feats, masks, video_ids,
                   seed: int, valid=None, noise_fn=None):
        """One CST step on a batch; ``seed`` keys the rollout noise and
        ``noise_fn(t) -> [K, B, V]`` replaces it."""
        t0 = time.perf_counter()
        greedy, samples = self.decode(state.model, feats, masks, seed,
                                      noise_fn)
        valid_np = self._valid_np(valid, len(video_ids))
        scored = self._score(greedy, samples, feats, masks, video_ids,
                             valid_np)
        t1 = time.perf_counter()
        state, metrics = self._apply(state, *scored)
        rows = samples if greedy is None else \
            torch.cat([greedy[None], samples])
        metrics.update(decode_s=t1 - t0 - metrics["reward_s"],
                       update_s=time.perf_counter() - t1,
                       decode_steps=decode_depth(rows, self.max_len,
                                                 self._stride))
        return state, metrics
