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

Observability (``obs/``): the ``rl.decode``, ``rl.reward`` and
``rl.update`` spans, the analytic ``flops.rl.decode`` / ``flops.rl.update``
counters, the ``rl.decode.depth`` histogram against the ``rl.decode.budget``
gauge and the ``rl.decode.compaction.*`` counters, all from host values
(the JAX package's names and integers). ``stats=True`` adds the update
ratios to the update's metrics and ``sample_entropy`` to the host metrics
(the flight recorder's streams). In the pipelined loop the scoring runs on
a worker thread, so its ``rl.reward`` span lands on that thread (the
report's overlap section); the main thread's wait for the score is a
``rl.reward`` span of its own, the part of the reward the pipeline did not
hide.

The reward call (:meth:`SCSTTrainer._reward_call`) visits the chaos point
``reward.call`` and runs under ``retry_call``: a transient failure is
retried by the ``retry=`` policy and logged through ``on_event`` as a
``reward_retry`` event, as in the JAX trainer.

Data parallel (``SCSTTrainer(mesh=...)``, a ``train.mesh.DataMesh``): each
rank decodes its own rows (:func:`make_parallel_rl_decode`, the noise of
its global rows, so the sharded rollouts equal the unsharded ones token
for token), scores them on the host, and the update
(:func:`make_parallel_rl_update`) sums the REINFORCE numerator, the token
count and the gradients over the ranks before the one division. A
drained pipeline's seam is gathered across the ranks, so a resume on the
same world size replays it.

Sequence parallel (``mesh`` a ``train.mesh.GridMesh``, the model an
``sp_model`` over its row): the decode and the update are
``parallel.seq_parallel``'s (``make_sp_decode``, ``make_sp_rl_update``),
each rank's rows its data coordinate's, its frames its shard; the rollout
noise is keyed by the data coordinate, so a row's ranks draw alike, and
the seam gathers one rank a row.

Model parallel (``mesh`` a ``('data', 'mp')`` ``GridMesh``): the ranks of an
``'mp'`` row are replicas, as the JAX training factories compute
mp-replicated. The decode and the update are the data-parallel ones over
the grid's data column (each rank's rows its data coordinate's, its noise
theirs), and the update's reduced gradients are broadcast over the row
(``row=``: ``train.steps.row_sync``); the seam gathers one rank a row.
``row`` names that ``'mp'`` row where ``mesh`` is a column already (the
learner side of a split over a grid, ``rl/async_scst.py``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import PAD_ID, RLConfig
from cst_captioning_tpu_torch.decoding.common import (
    _exit_stride,
    decode_depth,
    mask_from_tokens,
)
from cst_captioning_tpu_torch.decoding.fused import fused_decode
from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
from cst_captioning_tpu_torch.decoding.sample import sample_decode
from cst_captioning_tpu_torch.losses import reinforce_loss
from cst_captioning_tpu_torch.models.captioner import EncoderOutput
from cst_captioning_tpu_torch.obs import flops as _flops
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.resilience.health import collective_span
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy, retry_call
from cst_captioning_tpu_torch.rl.rewards import scb_baseline
from cst_captioning_tpu_torch.train.schedule import global_norm
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import data_axis, is_seq_grid, mp_row
from cst_captioning_tpu_torch.train.state import TrainState
from cst_captioning_tpu_torch.train.steps import (
    _apply,
    divide_grads,
    row_sync,
)

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


def compaction_stats(greedy_np, samples_np, stride: int, budget: int,
                     compact: bool = True) -> dict:
    """Host-side decode ledger from already-decoded tokens (no device reads)
    -> ``{depth, lanes_stepped, lanes_skipped}``: the depth the early-exit
    loop ran (next ``stride`` multiple of the longest row, capped at the
    padded budget), and the (lane, batch-column) steps a compacted decode
    computed vs skipped: a lane stops computing after its own (EOS
    inclusive) length, so ``sum(min(len, depth))`` of ``G*B*depth`` are
    stepped; without ``compact`` every lane rides to the early exit. The
    JAX package's function, the same integers."""
    lanes = []
    if greedy_np is not None and np.asarray(greedy_np).size:
        lanes.append(np.asarray(greedy_np)[None])
    if samples_np is not None and np.asarray(samples_np).size:
        lanes.append(np.asarray(samples_np))
    if not lanes:
        return {"depth": 0, "lanes_stepped": 0, "lanes_skipped": 0}
    toks = np.concatenate(lanes, axis=0)                      # [G, B, T]
    G, B, _ = toks.shape
    stride = max(int(stride), 1)
    padded = -(-int(budget) // stride) * stride
    lens = (toks != PAD_ID).sum(axis=-1)                      # [G, B]
    depth = min(padded, stride * -(-max(int(lens.max()), 1) // stride))
    total = G * B * depth
    stepped = int(np.minimum(lens, depth).sum()) if compact else total
    return {"depth": int(depth), "lanes_stepped": stepped,
            "lanes_skipped": int(total - stepped)}


def sample_entropy(samples_np) -> float:
    """Empirical token-distribution entropy (nats) of the sampled lanes,
    PAD excluded: the flight recorder's entropy-collapse signal (the JAX
    package's function)."""
    toks = np.asarray(samples_np).ravel()
    toks = toks[toks != PAD_ID]
    if toks.size == 0:
        return 0.0
    counts = np.bincount(toks)
    p = counts[counts > 0] / toks.size
    return float(-(p * np.log(p)).sum())


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
    return make_parallel_rl_decode(model, None, num_rollouts, temperature,
                                   max_len, with_greedy, fused)


def make_parallel_rl_decode(model, mesh, num_rollouts: int,
                            temperature: float = 1.0,
                            max_len: int | None = None,
                            with_greedy: bool = True,
                            fused: bool = True) -> Callable:
    """The data-parallel decode (:func:`make_rl_decode` on this rank's
    rows; ``mesh=None`` is the one-device decode): each rank decodes its
    own rows of the global batch (a decode has no cross-row interaction),
    drawing the noise of its global rows (``rollout_noise``'s
    ``row_offset``: the data coordinate (``mesh.rank``; a grid's
    column's) times the rows given, so on an actor or
    learner submesh its index within that side), and the rollouts of the
    global batch equal the one-rank decode's token for token at any world
    size or actor count. The JAX decode folds the axis index into its key
    instead; the port's draws differ from JAX's by design (module
    docstring)."""
    del model  # the decode call names the model that holds the params

    def decode(model, feats, masks, seed: int, noise_fn=None):
        B = next(iter(feats.values())).shape[0]
        # the rows' global index: the data coordinate's (a grid's column)
        offset = getattr(mesh, "data", mesh).rank * B if mesh is not None \
            else 0
        if with_greedy and fused:
            greedy, _, samples, _ = fused_decode(
                model, feats, masks, seed, num_rollouts=num_rollouts,
                temperature=temperature, max_len=max_len, noise_fn=noise_fn,
                row_offset=offset)
            return greedy, samples
        greedy = None
        if with_greedy:
            greedy, _ = greedy_decode(model, feats, masks, max_len=max_len)
        samples, _ = sample_decode(
            model, feats, masks, seed, num_rollouts=num_rollouts,
            temperature=temperature, max_len=max_len, noise_fn=noise_fn,
            row_offset=offset)
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
                        valid, chunks: int, reduce=None,
                        overlap: str = "off"):
    """REINFORCE sums and gradients accumulated over ``chunks`` slices of
    the K rollout axis, with one encoder pass shared by every chunk: each
    chunk differentiates the decode w.r.t. (params, encoder output), the
    encoder-output gradients accumulate in float32, and one backward
    through the encoder at the end folds them into the parameters.

    ``overlap`` ("defer" or "eager", with ``reduce(grads, async_op)`` ->
    a ``parallel.comms.Reduction``): each chunk's parameter gradients are
    reduced across the ranks as they come, and so are the encoder's at the
    end, so the returned gradients are reduced already. "defer" starts a
    chunk's reduction and waits for it after the next chunk's backward;
    "eager" waits at once. Both add the reduced chunks in one order, so
    they are bitwise equal."""
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
    pending = None    # "defer": the previous chunk's reduction in flight

    def add(acc, g):
        return [a if b is None else a + b for a, b in zip(acc, g)]

    for c in range(chunks):
        n_c, d_c = _decode_loss_sums(model, _tile_enc(enc, kc), sam[c], adv[c],
                                     valid_f)
        g = torch.autograd.grad(n_c, params + [cut[i] for i in diff],
                                allow_unused=True)
        g_p = g[:len(params)]
        if overlap == "off":
            gp = add(gp, g_p)
        else:
            g_p = [torch.zeros_like(p) if b is None else b
                   for p, b in zip(params, g_p)]
            if pending is not None:
                gp = add(gp, pending.wait())
            pending = reduce(g_p, overlap == "defer")
            if overlap == "eager":
                gp = add(gp, pending.wait())
                pending = None
        ge = [a + b.float() for a, b in zip(ge, g[len(params):])]
        num = num + n_c.detach()
        den = den + d_c
    if pending is not None:
        gp = add(gp, pending.wait())
    # one backward through the encoder, in the encoder output's dtypes
    g_enc = torch.autograd.grad(
        [leaves[i] for i in diff], params,
        grad_outputs=[e.to(leaves[i].dtype) for e, i in zip(ge, diff)],
        allow_unused=True)
    if overlap != "off":
        g_enc = reduce([torch.zeros_like(p) if b is None else b
                        for p, b in zip(params, g_enc)], False).wait()
    return num, den, add(gp, g_enc)


def make_rl_update(model, chunks: int = 1, guard: bool = False,
                   stats: bool = False, row=None) -> Callable:
    """-> update(state, feats, masks, samples [K, B, T], advantage [K, B],
    valid [B]) -> (state, metrics). ``chunks > 1`` accumulates the gradient
    over slices of the rollout axis (the same total gradient up to float
    summation order), divided as ``train.steps.divide_grads`` divides (a
    bfloat16 model's gradients and moments come out float32, as JAX's do
    there). The state's model is updated in place. ``stats``
    adds the update ratios (``train.steps.update_ratios``); ``row``, the
    ``'mp'`` row this update's ranks replicate (``train.steps.row_sync``)."""
    del model  # the state carries it; kept for the JAX factory's signature

    def update(state: TrainState, feats, masks, samples, advantage, valid):
        model = state.model
        params = state.params
        if chunks > 1:
            num, den, g_sum = _chunked_loss_grads(
                model, params, feats, masks, samples, advantage, valid, chunks)
            den = torch.clamp(den, min=1.0)
            loss = num / den
            grads = divide_grads(g_sum, den)
        else:
            K, B, T = samples.shape
            enc = model.encode(feats, masks)
            num, den = _decode_loss_sums(
                model, _tile_enc(enc, K), samples.reshape(K * B, T),
                advantage.reshape(K * B), valid.repeat(K))
            loss = num / torch.clamp(den, min=1.0)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
        grads, loss = row_sync(grads, loss, row)
        return _apply(state, grads, loss, global_norm(grads, state.leaves),
                      guard, key="rl_loss", stats=stats)

    return update


def make_parallel_rl_update(model, mesh, chunks: int = 1,
                            guard: bool = False, comm=None,
                            stats: bool = False, row=None) -> Callable:
    """The data-parallel REINFORCE update, in the sum form: each rank's
    ``(num, den)`` and the gradient of ``num`` over its rows, ``num`` and
    ``den`` summed in one all-reduce, the gradients by
    ``parallel.comms.GradReducer``, then the division by the global
    ``max(den, 1)`` and the update, alike on every rank. ``chunks``,
    ``guard``, ``stats`` and ``row`` as :func:`make_rl_update`. ``comm.overlap``
    "defer" / "eager" reduce each chunk's gradients as they come
    (:func:`_chunked_loss_grads`) and need ``chunks >= 2``."""
    from cst_captioning_tpu_torch.parallel.comms import (
        GradReducer,
        reduce_sums,
    )
    from cst_captioning_tpu_torch.train.mesh import param_leaves

    overlap = "off" if comm is None else comm.overlap
    if overlap != "off" and chunks < 2:
        raise ValueError(
            "comm overlap requires chunks >= 2: the rl.update_chunks "
            "boundary is the overlap seam (config validation enforces the "
            f"same; got chunks={chunks})")
    reducer = GradReducer(param_leaves(model), mesh, comm)

    def update(state: TrainState, feats, masks, samples, advantage, valid):
        model = state.model
        params = state.params
        if chunks > 1:
            num, den, g = _chunked_loss_grads(
                model, params, feats, masks, samples, advantage, valid,
                chunks, reduce=reducer.start, overlap=overlap)
        else:
            K, B, T = samples.shape
            enc = model.encode(feats, masks)
            num, den = _decode_loss_sums(
                model, _tile_enc(enc, K), samples.reshape(K * B, T),
                advantage.reshape(K * B), valid.repeat(K))
            g = torch.autograd.grad(num, params)
        num_t, den_t = reduce_sums(num, den, mesh)
        den_t = torch.clamp(den_t, min=1.0)
        if overlap == "off":
            g = reducer(g)
        grads, loss = row_sync(divide_grads(g, den_t), num_t / den_t, row)
        return _apply(state, grads, loss, global_norm(grads, state.leaves),
                      guard, key="rl_loss", stats=stats)

    return update


class SCSTTrainer:
    """Per-batch CST step: decode -> consensus reward -> REINFORCE update.

    ``baseline``: 'greedy' (SCST: the greedy rollout's reward), 'scb'
    (self-consensus across the other K-1 rollouts, CST_MS_SCB) or 'none'.
    ``guard=True`` adds the finite-update guard. The metrics carry the
    phase times in seconds (``decode_s`` up to the tokens on the host,
    ``reward_s``, ``update_s`` up to the loss on the host) and
    ``decode_steps``, the steps the early-exit loop ran (a multiple of the
    decode stride on the greedy baseline's strided loop). ``stats=True``
    adds the flight recorder's update ratios (module docstring).
    """

    # depth buckets sized to caption-length budgets (the JAX package's)
    _DEPTH_BUCKETS = (2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 16.0, 20.0, 24.0,
                      28.0, 32.0, 40.0, 48.0, 64.0)

    def __init__(self, model, reward, cfg: RLConfig,
                 max_len: int | None = None, guard: bool = False,
                 stats: bool = False, retry: RetryPolicy | None = None,
                 on_event=None, mesh=None, comm=None, row=None):
        self.model = model
        self.reward = reward
        self.cfg = cfg
        self.mesh = mesh
        self.comm = comm
        self.retry = retry or RetryPolicy()
        self.on_event = on_event or (lambda event, **fields: None)
        self.max_len = max_len or model.cfg.max_len
        # the obs ledger, host-side constants as the JAX SCSTTrainer sets
        # them (its exit-check granularity, not the port's launch stride)
        mc = model.cfg
        dims = dict(F=mc.max_frames, d_embed=mc.d_embed,
                    d_hidden=mc.d_hidden, d_att=mc.d_att, V=mc.vocab_size,
                    feat_dims=tuple(d for _, d in mc.modalities),
                    num_layers=mc.num_layers)
        self._depth_budget = self.max_len
        decode_stride = max(1, min(int(mc.decode_stride), self._depth_budget))
        self._compact = bool(mc.decode_compact)
        self._depth_stride = (
            decode_stride if decode_stride > 1 or self._compact
            else _exit_stride(self._depth_budget))
        self._decode_flops_per_clip = _flops.decode_flops_per_clip(
            K=cfg.num_rollouts, T=self._depth_budget,
            with_greedy=(cfg.baseline == "greedy"),
            stride=self._depth_stride, **dims)
        self._update_flops_per_clip = _flops.update_flops_per_clip(
            K=cfg.num_rollouts, T=self._depth_budget, **dims)
        self._update_probed = False
        obs.gauge("rl.decode.budget").set(float(self._depth_budget))
        # decode FLOPs are the analytic per-clip model
        obs.gauge("flops.backend.rl.decode").set(0.0)
        wg = cfg.baseline == "greedy"
        # the loop's stride: the fused decode's, or the per-step exit check
        stride = max(1, min(model.cfg.decode_stride, self.max_len))
        self._stride = stride if wg and stride > 1 else None
        # a grid's ranks of a row hold the same rows: on a ('data', 'seq')
        # grid the model reduces over the row, on a ('data', 'mp') grid
        # they are replicas that take the row's first rank's update
        self.sp = is_seq_grid(mesh)
        mp = row if row is not None else mp_row(mesh)
        self.row = mesh.seq if self.sp else mp
        if self.sp:
            from cst_captioning_tpu_torch.parallel.seq_parallel import (
                make_sp_decode,
                make_sp_rl_update,
            )

            self.decode = make_sp_decode(
                model, mesh, cfg.num_rollouts, cfg.temperature, max_len,
                with_greedy=wg)
            self.update = make_sp_rl_update(
                model, mesh, chunks=cfg.update_chunks, guard=guard,
                comm=comm, stats=stats)
        elif mesh is not None:
            column = data_axis(mesh)
            self.decode = make_parallel_rl_decode(
                model, column, cfg.num_rollouts, cfg.temperature, max_len,
                with_greedy=wg)
            self.update = make_parallel_rl_update(
                model, column, chunks=cfg.update_chunks, guard=guard,
                comm=comm, stats=stats, row=mp)
        else:
            self.decode = make_rl_decode(
                model, cfg.num_rollouts, cfg.temperature, max_len,
                with_greedy=wg)
            self.update = make_rl_update(model, chunks=cfg.update_chunks,
                                         guard=guard, stats=stats, row=mp)

    # ---- reward / advantage (host) ------------------------------------------

    def _reward_call(self, video_ids, rows):
        """The reward behind jittered-backoff retries: a transient failure
        (a scoring service's) is retried, not fatal; ``reward.call`` lets
        the chaos harness inject one."""

        def call():
            chaos.visit("reward.call")
            return self.reward(video_ids, rows)

        return retry_call(
            call, policy=self.retry,
            on_retry=lambda info: self.on_event("reward_retry", **info))

    def _advantage(self, greedy, samples_np, video_ids, valid_np):
        """-> (advantage [K, B] np, metrics dict)."""
        K = self.cfg.num_rollouts
        B = samples_np.shape[1]
        r_samples = self._reward_call(video_ids,
                                      samples_np.reshape(K * B, -1))
        r_kb = r_samples.reshape(K, B)

        if self.cfg.baseline == "greedy":
            if greedy is None:
                raise ValueError(
                    "baseline='greedy' needs the greedy rollout; the decode "
                    "was built with with_greedy=False")
            r_greedy = self._reward_call(video_ids, np.asarray(greedy))
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
        # the token readback and the consensus scoring: the host half
        with obs.span("rl.reward"):
            host = host or (_host_copy(greedy), _host_copy(samples))
            greedy_np, samples_np = (_host_numpy(c) for c in host)
            t = time.perf_counter()
            entropy = self._observe_decode(greedy_np, samples_np)
            advantage, host_metrics = self._advantage(
                greedy_np, samples_np, video_ids, valid_np)
            if entropy is not None:
                host_metrics["sample_entropy"] = entropy
            host_metrics["reward_s"] = time.perf_counter() - t
            rows = samples_np if greedy_np is None else \
                np.concatenate([greedy_np[None], samples_np])
            host_metrics["decode_steps"] = decode_depth(rows, self.max_len,
                                                        self._stride)
        return advantage, host_metrics, samples, feats, masks, valid_np

    def _observe_decode(self, greedy_np, samples_np) -> float | None:
        """Decode accounting from the tokens on the host: the analytic
        ``flops.rl.decode`` counter, the early-exit depth histogram and the
        compaction counter pair; -> the sampled lanes' entropy for the
        flight recorder, or None when obs is off."""
        obs.counter("flops.rl.decode").inc(
            samples_np.shape[1] * self._decode_flops_per_clip)
        if not obs.enabled():
            return None
        st = compaction_stats(greedy_np, samples_np, self._depth_stride,
                              self._depth_budget, compact=self._compact)
        obs.histogram("rl.decode.depth", self._DEPTH_BUCKETS).observe(
            st["depth"])
        obs.counter("rl.decode.compaction.lanes_stepped").inc(
            st["lanes_stepped"])
        obs.counter("rl.decode.compaction.lanes_skipped").inc(
            st["lanes_skipped"])
        return sample_entropy(samples_np)

    def _apply(self, state, advantage, host_metrics, samples, feats, masks,
               valid_np):
        """Device half: upload the advantage, run the REINFORCE update."""
        with obs.span("rl.update"):
            dev = samples.device
            adv = torch.from_numpy(np.asarray(advantage, np.float32)).to(dev)
            valid = torch.from_numpy(np.asarray(valid_np, np.float32)).to(dev)
            if not self._update_probed and obs.enabled():
                # the JAX trainer probes a compiled cost here; the port's is
                # the analytic model, and the backend gauge says so
                self._update_probed = True
                obs.counter("obs.flops.probes").inc()
                obs.gauge("flops.backend.rl.update").set(0.0)
            obs.counter("flops.rl.update").inc(
                len(valid_np) * self._update_flops_per_clip)
            args = (state, feats, masks, samples, adv, valid)
            if self.mesh is not None and self.comm is not None:
                # the update carries the gradient all-reduce: its span is
                # the JAX trainer's, where collective stalls show
                with collective_span("rl.update.allreduce"):
                    state, metrics = self.update(*args)
            else:
                state, metrics = self.update(*args)
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
        with obs.span("rl.decode"):
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

    def _row_ranks(self) -> int:
        """Ranks a data coordinate spans: a grid row's width (its ranks
        hold the same rows), else 1."""
        return self.row.world if self.row is not None else 1

    def _gather_rows(self, t, dim: int) -> np.ndarray:
        """Every data coordinate's rows of ``t``, in order, on the host."""
        S = self._row_ranks()
        full = multihost.allgather_to_host(t, dim=dim)
        if S == 1:
            return full
        parts = np.split(full, multihost.process_count(), axis=dim)
        return np.concatenate(parts[::S], axis=dim)

    def _seam_capture(self, decoded, video_ids) -> dict:
        """Host copies of a decoded, unscored batch's tokens, gathered
        across the ranks (the global batch's rows, in rank order), so any
        rank of a resumed run can replay its share."""
        greedy, samples = decoded
        out = {"samples": self._gather_rows(samples, 1),
               "video_ids": self._global_ids(video_ids)}
        if greedy is not None:
            out["greedy"] = self._gather_rows(greedy, 0)
        return out

    def _seam_tokens_to_device(self, seam: dict, device):
        """Persisted seam tokens -> (greedy or None, samples) of this
        rank's rows on ``device``, as the decode gives them."""
        if self.row is None:
            put = multihost.put_full_global
        else:
            d = data_axis(self.mesh)
            rank, world = (d.rank, d.world) if d is not None else (0, 1)

            def put(x, device, dim):
                t = torch.as_tensor(np.asarray(x))
                n = t.shape[dim] // world
                return t.narrow(dim, rank * n, n).to(device)

        samples = put(np.asarray(seam["samples"]), device, dim=1)
        greedy = seam.get("greedy")
        if greedy is not None:
            greedy = put(np.asarray(greedy), device, dim=0)
        return greedy, samples

    def _global_ids(self, video_ids) -> list[str]:
        parts = multihost.allgather_pyobj([str(v) for v in video_ids])
        return [str(i) for part in parts[::self._row_ranks()] for i in part]

    def _seam_matches(self, seam: dict, video_ids) -> bool:
        return list(seam.get("video_ids", [])) == self._global_ids(video_ids)

    # ---- an epoch ----------------------------------------------------------

    def train_epoch(self, state: TrainState, batches, seeds,
                    on_step=None, pipelined: bool = True, should_stop=None,
                    seam: dict | None = None,
                    seam_sink: dict | None = None, noise_fns=None,
                    abandon=None):
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

        ``abandon()`` is read when the epoch stops: true means the stop is
        a peer lost on real ranks, and the drain then enters no collective
        of the group that held it. A pending pipelined update, whose
        all-reduce has not run, is not applied, and no seam is captured
        (gathering it is a collective too). The state is then exactly the
        updates applied so far, ``len(metrics)`` steps on, and a resume
        from its save decodes the first unapplied batch again. Seam replay
        stays for a stop on a whole group (SIGTERM, a rejoin's drain, and
        simulated hosts in one process).
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
            with obs.span("rl.decode"):
                greedy, samples = self.decode(state.model, feats, masks,
                                              seeds(j), noise(j))
                return greedy, samples, (_host_copy(greedy),
                                         _host_copy(samples))

        def score_result(fut):
            # the part of the reward the pipeline did not hide
            with obs.span("rl.reward"):
                return fut.result()

        scored = None     # future: _apply args of batch i-2
        decoded = None    # _score args of batch i-1
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="rl-score")
        try:
            for j, (feats, masks, video_ids, valid) in enumerate(batches):
                valid_np = self._valid_np(valid, len(video_ids))
                if should_stop is not None and should_stop():
                    if abandon is not None and abandon():
                        # the pending updates' all-reduces would meet a
                        # dead rank: drop them, and the seam with them
                        scored = decoded = None
                        break
                    if seam_sink is not None:
                        if scored is not None:
                            state, m = self._apply(state,
                                                   *score_result(scored))
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
                    state, m = self._apply(state, *score_result(scored))
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
                state, m = self._apply(state, *score_result(scored))
                emit(m)
            if decoded is not None:
                state, m = self._apply(state, *self._score(*decoded))
                emit(m)
        finally:
            pool.shutdown(wait=True)
        return state, out
