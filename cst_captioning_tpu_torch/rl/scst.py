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

:meth:`SCSTTrainer.train_epoch` runs an epoch of batches, strictly
sequential or pipelined (update(i-2) -> decode(i) -> score(i-1)), with a
drain that stops at a batch boundary and the seam: the tokens a drained
pipeline decoded but did not score, persisted and replayed on resume.

Rollout seeds: the port's rollout noise is a counter hash of an integer
seed, not a JAX key, so the seed of each batch is :func:`rollout_seed` of
``(train.seed + 1, data salt, epoch, batch index)``. A resumed epoch thus
continues the stream without replaying a split chain; the draws differ
from the JAX trainer's by design, and parity tests feed the JAX draws in
through ``noise_fn``.

Not carried from the JAX trainer: meshes, reward retries and chaos hooks,
and the obs spans and counters.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
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

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def rollout_seed(seed: int, salt: int, epoch: int, batch_index: int) -> int:
    """The rollout-noise seed of one RL batch: a fixed hash of
    ``(seed, data salt, epoch, batch index)`` (the trainer passes
    ``train.seed + 1`` as ``seed``), so the stream of a resumed epoch
    continues where the interrupted one stopped."""
    x = 0x9E3779B97F4A7C15
    for v in (seed, salt, epoch, batch_index):
        x = _mix64((x + (int(v) & _M64)) & _M64)
    return x & 0x7FFFFFFF


def _host_copy(t: torch.Tensor | None):
    """Start copying ``t`` to the host: -> (host tensor, event or None).
    On CUDA the copy goes to pinned memory without blocking; reading the
    host tensor waits for the event first."""
    if t is None:
        return None
    if t.device.type != "cuda":
        return t.detach().cpu(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_numpy(copy) -> np.ndarray | None:
    if copy is None:
        return None
    host, event = copy
    if event is not None:
        event.synchronize()
    return host.numpy()


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

    def _score(self, greedy, samples, feats, masks, video_ids, valid_np,
               host=None):
        """Host half: read the tokens back and compute the advantage ->
        the argument tuple of :meth:`_apply`. ``host`` is a started
        :func:`_host_copy` of (greedy, samples)."""
        host = host or (_host_copy(greedy), _host_copy(samples))
        greedy_np, samples_np = (_host_numpy(c) for c in host)
        t = time.perf_counter()
        advantage, host_metrics = self._advantage(
            greedy_np, samples_np, video_ids, valid_np)
        host_metrics["reward_s"] = time.perf_counter() - t
        rows = samples_np if greedy_np is None else \
            np.concatenate([greedy_np[None], samples_np])
        host_metrics["decode_steps"] = decode_depth(rows, self.max_len,
                                                    self._stride)
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
        metrics.update(decode_s=t1 - t0 - metrics["reward_s"],
                       update_s=time.perf_counter() - t1)
        return state, metrics

    # ---- the seam of a drained pipeline -----------------------------------

    @staticmethod
    def _seam_capture(decoded, video_ids) -> dict:
        """Host copies of a decoded, unscored batch's tokens."""
        greedy, samples = decoded
        out = {"samples": samples.cpu().numpy(),
               "video_ids": [str(v) for v in video_ids]}
        if greedy is not None:
            out["greedy"] = greedy.cpu().numpy()
        return out

    @staticmethod
    def _seam_tokens_to_device(seam: dict, device):
        """Persisted seam tokens -> (greedy or None, samples) on
        ``device``, as the decode gives them."""
        samples = torch.from_numpy(np.asarray(seam["samples"])).to(device)
        greedy = seam.get("greedy")
        if greedy is not None:
            greedy = torch.from_numpy(np.asarray(greedy)).to(device)
        return greedy, samples

    @staticmethod
    def _seam_matches(seam: dict, video_ids) -> bool:
        return list(seam.get("video_ids", [])) == [str(v) for v in video_ids]

    # ---- an epoch ----------------------------------------------------------

    def train_epoch(self, state: TrainState, batches, seeds,
                    on_step=None, pipelined: bool = True, should_stop=None,
                    seam: dict | None = None,
                    seam_sink: dict | None = None, noise_fns=None):
        """CST over an epoch of batches -> (state, metrics list).

        ``batches`` yields ``(feats, masks, video_ids, valid)`` with the
        arrays on the device; ``seeds(j)`` is the rollout seed of the
        ``j``-th batch this call takes (0-based), ``noise_fns(j)``
        (optional) its ``noise_fn``. ``on_step(metrics)`` fires per step.

        ``pipelined=False``: :meth:`train_step` per batch, decode -> score
        -> update. ``pipelined=True``: per batch ``i`` the order is
        update(i-2) -> decode(i) -> score(i-1), as in the JAX loop: the
        decoded policy is one update stale. The state is updated in
        place, in that order, on one stream; the decode's early exit reads
        the device, so score(i-1) runs on a worker thread while this
        thread drives decode(i), and the tokens reach the host through
        pinned memory and an event.

        ``should_stop()`` is read once a batch. When it turns true the
        epoch stops taking batches and drains: every decoded batch gets
        its update, so the state is exactly ``len(metrics)`` steps on.
        With ``seam_sink`` (pipelined) the drain first runs the stopped
        iteration's update(i-2) and decode(i) and puts batch i's tokens
        into ``seam_sink``; a resume that passes them back as ``seam``
        replays them for its first batch (when its video ids match)
        instead of decoding it again, so the resumed run equals the
        uninterrupted one.
        """
        out = []
        dev = state.model.device

        def emit(m):
            out.append(m)
            if on_step is not None:
                on_step(m)

        noise = (lambda j: None) if noise_fns is None else noise_fns

        if not pipelined:
            for j, (feats, masks, video_ids, valid) in enumerate(batches):
                if should_stop is not None and should_stop():
                    break
                state, m = self.train_step(state, feats, masks, video_ids,
                                           seeds(j), valid,
                                           noise_fn=noise(j))
                emit(m)
            return state, out

        def decode(j, feats, masks):
            greedy, samples = self.decode(state.model, feats, masks,
                                          seeds(j), noise(j))
            return greedy, samples, (_host_copy(greedy), _host_copy(samples))

        scored = None     # future: _apply args of batch i-2
        decoded = None    # _score args of batch i-1
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="rl-score")
        try:
            for j, (feats, masks, video_ids, valid) in enumerate(batches):
                valid_np = self._valid_np(valid, len(video_ids))
                if should_stop is not None and should_stop():
                    if seam_sink is not None:
                        if scored is not None:
                            state, m = self._apply(state, *scored.result())
                            scored = None
                            emit(m)
                        greedy, samples, _ = decode(j, feats, masks)
                        seam_sink.update(self._seam_capture(
                            (greedy, samples), video_ids))
                        if decoded is not None:
                            state, m = self._apply(
                                state, *self._score(*decoded))
                            emit(m)
                        decoded = None
                    break
                if scored is not None:
                    state, m = self._apply(state, *scored.result())
                    scored = None
                    emit(m)
                if decoded is not None:
                    # the host scores batch i-1 while decode(i) runs
                    scored = pool.submit(self._score, *decoded)
                if j == 0 and seam is not None and self._seam_matches(
                        seam, video_ids):
                    greedy, samples = self._seam_tokens_to_device(seam, dev)
                    host = (_host_copy(greedy), _host_copy(samples))
                else:
                    greedy, samples, host = decode(j, feats, masks)
                decoded = (greedy, samples, feats, masks, video_ids,
                           valid_np, host)
            # drain in order: update(n-2), then score and update(n-1)
            if scored is not None:
                state, m = self._apply(state, *scored.result())
                emit(m)
            if decoded is not None:
                state, m = self._apply(state, *self._score(*decoded))
                emit(m)
        finally:
            pool.shutdown(wait=True)
        return state, out
