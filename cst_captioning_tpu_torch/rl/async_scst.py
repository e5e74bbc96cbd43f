"""Decoupled actor/learner SCST on one device (the JAX package's
``rl/async_scst.py``).

``train.rl_topology="decoupled"``: an actor decodes rollout batches into a
:class:`RolloutRing` (sampled tokens, their logprobs and the greedy lane,
``rl.rollout_depth`` batches deep) and a learner consumes the oldest entry
once the ring is full, with the sync trainer's reward, advantage and
REINFORCE update. A rollout decoded under parameters more than
``rl.staleness_bound`` learner updates old at consumption is DROPPED and
recounted: decoded again under the current parameters from the entry's own
seed and noise, so the drop and recount sequence is the same run to run.

One device, one stream. The JAX package splits the data mesh into actor
and learner submeshes; here actor and learner share the device and its
stream, and a layout of more than one device raises (the actor/learner
slice brings the split across ranks, with ``shrink_actors`` /
``grow_actors``). The learner updates ``state.model``
in place; the ring stays correct because each decode is launched on the
stream before the updates it must not see. The actor's "broadcast"
(``rl.actor.broadcast``) is a rebind of the learner's model.

STRICT mode (``strict=True``, or ``rollout_depth=1`` with
``staleness_bound=0``) replays the sync loop's schedule: depth 2 is
:meth:`SCSTTrainer.train_epoch`'s pipeline (decode(i) one update stale,
update(i-1) after decode(i)), depth 1 its ``pipelined=False`` loop, and
the tokens, metrics and parameters equal the sync loop's bit for bit.

Seeds. ``train_epoch`` takes the port's ``seeds(j)`` and optional
``noise_fns(j)`` where the JAX loop takes a key it splits per batch; a ring
entry stores its batch's integer seed and its index ``j``, and a recount
decodes from both again.

Preemption. :func:`request_actor_preempt` queues a preemption the epoch
services at its next batch boundary: on one device no actor survives it,
so the in-flight entries are recounted under the learner and the epoch
falls back to the sync schedule (``rl_actor_fallback_sync``).
:func:`request_actor_rejoin` is a no-op without a split plan. Drain:
``should_stop`` persists the in-flight ring into ``seam_sink`` (the
trainer's ``seam.npz`` ring layout) and a resume replays those tokens;
strict drains resume bit for bit.

Observability (the JAX names): the ``rl.actor.broadcast``,
``rl.actor.decode`` and ``rl.learner.step`` spans, the
``rl.actor.batches``, ``rl.learner.steps``, ``rl.staleness.dropped``,
``rl.actor.preempted`` and ``rl.actor.rejoined`` counters, the
``rl.staleness`` histogram and the host-observed ``rl.actor.occupancy``
and ``rl.learner.occupancy`` gauges.

Chaos: the loop visits ``rl.actor.step`` once a batch while it has not
fallen back to the sync schedule, before it services rejoins and
preemptions, so a fault plan's ``actor_preempt`` lands at that batch's
boundary (``resilience/chaos.py``).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import RLConfig
from cst_captioning_tpu_torch.decoding.fused import fused_decode
from cst_captioning_tpu_torch.decoding.sample import sample_decode
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.rl.scst import SCSTTrainer, _host_copy
from cst_captioning_tpu_torch.train.state import TrainState

# pending actor preemptions and rejoins; the running epoch services them
# at its next batch boundary
_PREEMPT_REQUESTS: list[int] = []
_REJOIN_REQUESTS: list[int] = []


def request_actor_preempt(slice_index=None) -> None:
    """Mark one actor device (by index into the actor submesh) as
    preempted; the running :class:`AsyncSCSTTrainer` epoch services it at
    its next batch boundary."""
    _PREEMPT_REQUESTS.append(0 if slice_index is None else int(slice_index))


def request_actor_rejoin(slice_index=None) -> None:
    """Inverse of :func:`request_actor_preempt`: re-admit one shed actor
    device (by index into the initial actor submesh)."""
    _REJOIN_REQUESTS.append(0 if slice_index is None else int(slice_index))


def _covered_s(windows) -> float:
    """Seconds covered by the union of (start, end) windows."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(windows):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def make_actor_decode(model, num_rollouts: int, temperature: float = 1.0,
                      max_len: int | None = None, with_greedy: bool = True):
    """-> decode(model, feats, masks, seed, noise_fn=None) -> (greedy
    [B, T] or None, samples [K, B, T], sample logprobs [K, B, T]).

    The same calls as ``make_rl_decode`` (``fused_decode`` with the greedy
    lane, ``sample_decode`` without), so strict mode's tokens equal the
    sync loop's; this decode keeps the sampled lanes' logprobs."""
    del model  # the decode call names the model that holds the params

    def decode(model, feats, masks, seed: int, noise_fn=None):
        if with_greedy:
            greedy, _, samples, lps = fused_decode(
                model, feats, masks, seed, num_rollouts=num_rollouts,
                temperature=temperature, max_len=max_len, noise_fn=noise_fn)
            return greedy, samples, lps
        samples, lps = sample_decode(
            model, feats, masks, seed, num_rollouts=num_rollouts,
            temperature=temperature, max_len=max_len, noise_fn=noise_fn)
        return None, samples, lps

    return decode


class RolloutRing:
    """Ring of decoded rollout batches on the learner's device (the
    actor -> learner handoff; depth 2 is the double buffer).

    Storage is three tensors allocated at the first push: sampled tokens
    [D, K, B, T], their logprobs [D, K, B, T] and, with a greedy lane,
    [D, B, T], written a slot at a time with ``copy_``, so the ring holds
    ``depth`` batches whatever streams through it. Each entry's host
    metadata (seed, version, batch, video ids) waits in a deque. A read
    returns views of a slot: the next push into that slot is ordered
    after every use of the views on the device's stream.
    """

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._tokens = None      # [D, K, B, T] sampled tokens
        self._lps = None         # [D, K, B, T] sample logprobs
        self._greedy = None      # [D, B, T] greedy baseline (optional)
        self._meta: deque = deque()
        self._slot = 0

    def __len__(self) -> int:
        return len(self._meta)

    def _alloc(self, like: torch.Tensor, device) -> torch.Tensor:
        return torch.empty((self.depth,) + tuple(like.shape),
                           dtype=like.dtype, device=device)

    def push(self, greedy, samples, lps, device=None, **meta) -> None:
        """Write one decoded batch into the next slot and queue its
        metadata. Batch shapes are constant across an epoch (the
        video-mode batcher wrap-pads). ``device`` (default the samples')
        holds the ring; host tensors are copied onto it."""
        slot = self._slot
        self._slot = (slot + 1) % self.depth
        if self._tokens is None:
            dev = samples.device if device is None else device
            self._tokens = self._alloc(samples, dev)
            self._lps = self._alloc(lps, dev)
            if greedy is not None:
                self._greedy = self._alloc(greedy, dev)
        self._tokens[slot].copy_(samples, non_blocking=True)
        self._lps[slot].copy_(lps, non_blocking=True)
        if greedy is not None:
            self._greedy[slot].copy_(greedy, non_blocking=True)
        self._meta.append(dict(slot=slot, **meta))

    def _read(self, meta):
        slot = meta["slot"]
        greedy = None if self._greedy is None else self._greedy[slot]
        return meta, greedy, self._tokens[slot], self._lps[slot]

    def pop(self):
        """Oldest entry -> (meta, greedy, samples, lps)."""
        return self._read(self._meta.popleft())

    def entries(self):
        """Every in-flight entry, oldest first, without consuming (the
        seam capture's read)."""
        for meta in list(self._meta):
            yield self._read(meta)

    def drain_meta(self) -> list[dict]:
        """Drop the buffers (the actor died under them) and return the
        orphaned metadata, so the caller can recount each entry from its
        seed."""
        metas = list(self._meta)
        self._meta.clear()
        self._tokens = self._lps = self._greedy = None
        self._slot = 0
        return metas


class AsyncSCSTTrainer(SCSTTrainer):
    """SCSTTrainer with the actor/learner ring schedule on one device.

    The parent's reward, advantage and update halves are reused as they
    are; the actor gets its own decode (:func:`make_actor_decode`) and a
    :class:`RolloutRing`. ``devices`` (default: the model's) names the
    layout; more than one device raises, as the split is not ported.
    ``batch_size`` is the JAX trainer's (it clamps a split to batch
    divisors) and kept for its signature. ``on_event(event, **fields)``
    receives the fallback and seam events.
    """

    # staleness-in-updates buckets: small integers, not latencies
    _STALE_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

    def __init__(self, model, reward, cfg: RLConfig,
                 max_len: int | None = None, guard: bool = False,
                 stats: bool = False, strict: bool = False,
                 batch_size: int = 0, devices=None, on_event=None,
                 retry=None):
        if devices is not None and len({str(d) for d in devices}) > 1:
            raise ValueError(
                f"AsyncSCSTTrainer got {len(devices)} devices: the "
                "actor/learner split across devices is not ported yet "
                "(the actor/learner slice); run it on one device")
        depth = max(1, int(cfg.rollout_depth))
        bound = max(0, int(cfg.staleness_bound))
        # depth 1 + bound 0 IS the strict sequential schedule
        implicit = depth == 1 and bound == 0
        self._strict = bool(strict) or implicit
        if strict:
            # the sync loop's default pipeline is a depth-2 ring (decode(i)
            # one update stale, update(i-1) after decode(i));
            # pipelined=False is the depth-1 sequential ring
            depth = 2 if cfg.pipelined else 1
            bound = depth - 1
        elif implicit:
            depth, bound = 1, 0
        super().__init__(model, reward, cfg, max_len=max_len, guard=guard,
                         stats=stats, retry=retry, on_event=on_event)
        self._batch_size = int(batch_size)
        self._wg = cfg.baseline == "greedy"
        self._depth = depth
        self._bound = bound
        self._actor_decode = make_actor_decode(
            model, cfg.num_rollouts, cfg.temperature, max_len,
            with_greedy=self._wg)
        self._ring = RolloutRing(depth)
        self._fallback_sync = False
        self._actor_model = None
        self._actor_version = -1
        self._learner_version = 0
        # per-epoch ledgers the smoke run and the tests read back
        self.last_staleness: dict[int, int] = {}
        self.last_dropped = 0
        self.last_rejoined = 0
        self.last_occupancy: dict[str, float] = {}
        # host-observed busy windows of the running epoch, by role
        self._windows: dict[str, list] = {"actor": [], "learner": []}

    # ---- actor plumbing ------------------------------------------------------

    def _refresh_actor(self, state: TrainState) -> None:
        """Point the actor at the learner's current parameters. On one
        device it is a rebind: the model is updated in place on the one
        stream, so a decode launched now sees exactly this version."""
        if self._actor_version == self._learner_version:
            return
        with obs.span("rl.actor.broadcast"):
            self._actor_model = state.model
        self._actor_version = self._learner_version

    def _dispatch_decode(self, feats, masks, seed: int, noise_fn):
        """One actor decode -> (greedy, samples, lps, host copies of
        (greedy, samples) started). The decode's early exit reads the
        device, so its call is the actor's busy window up to the last
        stride; a consume that waits for the tokens adds the rest."""
        t0 = time.perf_counter()
        with obs.span("rl.actor.decode"):
            greedy, samples, lps = self._actor_decode(
                self._actor_model, feats, masks, seed, noise_fn)
            host = (_host_copy(greedy), _host_copy(samples))
        self._windows["actor"].append((t0, time.perf_counter()))
        obs.counter("rl.actor.batches").inc()
        return greedy, samples, lps, host

    # ---- preemption ----------------------------------------------------------

    def _service_preemptions(self) -> list[dict]:
        """Apply pending preemptions -> the orphaned ring metadata to
        recount. One device has no actor to shed and keep the rest: the
        epoch falls back to the sync schedule."""
        lost: list[dict] = []
        while _PREEMPT_REQUESTS:
            _PREEMPT_REQUESTS.pop(0)
            obs.counter("rl.actor.preempted").inc()
            if self._fallback_sync:
                continue
            lost.extend(self._ring.drain_meta())
            self._fallback_sync = True
            self.on_event("rl_actor_fallback_sync", recount=len(lost))
            self._actor_version = -1
        return lost

    def _service_rejoins(self) -> list[dict]:
        """Apply pending rejoins: without a split plan nothing was shed, so
        each is counted and changes nothing."""
        while _REJOIN_REQUESTS:
            _REJOIN_REQUESTS.pop(0)
            obs.counter("rl.actor.rejoined").inc()
        return []

    # ---- the drain's ring seam ---------------------------------------------

    def _seam_capture_ring(self) -> dict:
        """Host copies of every in-flight ring entry (tokens, logprobs,
        seed, batch): the decoupled drain's payload. Runs once a drain,
        ``depth`` entries at most."""
        ring = []
        for meta, greedy, samples, lps in self._ring.entries():
            e = {"samples": samples.cpu().numpy(),
                 "lps": lps.cpu().numpy(),
                 "video_ids": [str(v) for v in meta["video_ids"]],
                 "valid": np.asarray(meta["valid_np"], np.float32),
                 "seed": int(meta["seed"]),
                 "batch_index": int(meta["batch_index"])}
            if greedy is not None:
                e["greedy"] = greedy.cpu().numpy()
            ring.append(e)
        return {"ring": ring}

    def _replay_entry(self, entry: dict, feats, masks, video_ids, valid_np,
                      batch_index: int, j: int, seed: int) -> None:
        """Push one persisted seam entry back into the ring as if just
        decoded: its tokens and logprobs come from the seam; a later
        recount decodes from the entry's seed (a seam the JAX package
        wrote stores a key, so the batch's own ``seed`` stands in) and
        batch ``j``'s noise; its version is the actor's current one."""
        dev = self.model.device
        samples = torch.from_numpy(np.asarray(entry["samples"]))
        lps = torch.from_numpy(np.asarray(entry["lps"], np.float32))
        greedy = entry.get("greedy")
        if greedy is not None:
            greedy = torch.from_numpy(np.asarray(greedy))
        self._ring.push(
            greedy, samples, lps, device=dev,
            seed=int(entry.get("seed", seed)), j=j,
            version=self._actor_version, feats=feats, masks=masks,
            video_ids=video_ids, valid_np=valid_np, batch_index=batch_index,
            host=((greedy, None) if greedy is not None else None,
                  (samples, None)))

    # ---- the decoupled epoch --------------------------------------------------

    def train_epoch(self, state: TrainState, batches, seeds, on_step=None,
                    pipelined: bool = True, should_stop=None,
                    seam: dict | None = None,
                    seam_sink: dict | None = None, noise_fns=None):
        """Actor/learner epoch -> (state, metrics list). The sync loop's
        ``pipelined`` flag is subsumed by the ring schedule and ignored.
        ``seeds(j)`` and ``noise_fns(j)`` as in
        :meth:`SCSTTrainer.train_epoch`. Every batch not persisted into
        ``seam_sink`` gets exactly one applied update, so the state is
        ``len(metrics)`` steps on; with ``seam_sink`` a stop persists the
        in-flight ring there, and a resume that passes it back as ``seam``
        replays its tokens for the batches whose video ids match."""
        del pipelined
        noise = (lambda j: None) if noise_fns is None else noise_fns
        out: list[dict] = []

        def emit(m):
            out.append(m)
            if on_step is not None:
                on_step(m)

        _PREEMPT_REQUESTS.clear()
        _REJOIN_REQUESTS.clear()
        self._ring = RolloutRing(self._depth)
        self._actor_model = None
        self._actor_version = -1
        self._learner_version = 0
        self.last_staleness = {}
        self.last_dropped = 0
        self.last_rejoined = 0
        replay: deque = deque(seam.get("ring", []) if seam else [])
        t0 = time.perf_counter()
        self._windows = {"actor": [], "learner": []}

        def recount(meta, state):
            """Decode an orphaned or over-stale entry again under the
            current parameters, from its own seed and noise."""
            self._refresh_actor(state)
            greedy, samples, lps, host = self._dispatch_decode(
                meta["feats"], meta["masks"], meta["seed"],
                noise(meta["j"]))
            meta = dict(meta, version=self._actor_version, host=host)
            return meta, greedy, samples, lps

        def consume(state, meta, greedy, samples, lps):
            """Score and update one ring entry, dropping and recounting it
            first if its parameters are over-stale."""
            with obs.span("rl.learner.step"):
                stale = self._learner_version - meta["version"]
                if stale > self._bound:
                    obs.counter("rl.staleness.dropped").inc()
                    self.last_dropped += 1
                    meta, greedy, samples, lps = recount(meta, state)
                    stale = self._learner_version - meta["version"]
                self.last_staleness[stale] = (
                    self.last_staleness.get(stale, 0) + 1)
                obs.histogram("rl.staleness", self._STALE_BUCKETS).observe(
                    float(stale))
                # a wait for the tokens' host copies is the actor's; the
                # score then reads them without a further wait
                t_wait = time.perf_counter()
                for copy in meta["host"]:
                    if copy is not None and copy[1] is not None:
                        copy[1].synchronize()
                self._windows["actor"].append((t_wait, time.perf_counter()))
                scored = self._score(greedy, samples, meta["feats"],
                                     meta["masks"], meta["video_ids"],
                                     meta["valid_np"], host=meta["host"])
                t_disp = time.perf_counter()
                # the update reads its loss back: it ends on the host
                state, m = self._apply(state, *scored)
                self._windows["learner"].append(
                    (t_disp, time.perf_counter()))
            obs.counter("rl.learner.steps").inc()
            self._learner_version += 1
            emit(m)
            return state

        stopped = False
        batch_index = -1
        for j, (feats, masks, video_ids, valid) in enumerate(batches):
            batch_index += 1
            if should_stop is not None and should_stop():
                stopped = True
                break
            if not self._fallback_sync:
                chaos.visit("rl.actor.step")
            lost = self._service_rejoins() + self._service_preemptions()
            for meta in lost:
                # the orphaned in-flight rollouts, in order, under the
                # learner
                state = consume(state, *recount(meta, state))
            if self._fallback_sync:
                state, m = self.train_step(state, feats, masks, video_ids,
                                           seeds(j), valid,
                                           noise_fn=noise(j))
                self._learner_version += 1
                emit(m)
                continue
            self._refresh_actor(state)
            valid_np = self._valid_np(valid, len(video_ids))
            if replay and list(replay[0]["video_ids"]) == [
                    str(v) for v in video_ids]:
                self._replay_entry(replay.popleft(), feats, masks, video_ids,
                                   valid_np, batch_index, j, seeds(j))
            else:
                if replay:
                    # a changed data order: never marry old tokens to new
                    # features
                    self.on_event("seam_ring_discarded", entries=len(replay))
                    replay.clear()
                greedy, samples, lps, host = self._dispatch_decode(
                    feats, masks, seeds(j), noise(j))
                self._ring.push(
                    greedy, samples, lps, seed=seeds(j), j=j,
                    version=self._actor_version, feats=feats, masks=masks,
                    video_ids=video_ids, valid_np=valid_np,
                    batch_index=batch_index, host=host)
            while len(self._ring) >= self._depth:
                state = consume(state, *self._ring.pop())
        if stopped and seam_sink is not None and len(self._ring):
            # a drain: the in-flight ring persists instead of being
            # consumed, and the resume replays these tokens
            seam_sink.update(self._seam_capture_ring())
        else:
            while len(self._ring):
                state = consume(state, *self._ring.pop())
        wall = max(time.perf_counter() - t0, 1e-9)
        occ = {role: min(1.0, _covered_s(w) / wall)
               for role, w in self._windows.items()}
        self.last_occupancy = dict(occ, wall_s=wall)
        obs.gauge("rl.actor.occupancy").set(occ["actor"])
        obs.gauge("rl.learner.occupancy").set(occ["learner"])
        return state, out
