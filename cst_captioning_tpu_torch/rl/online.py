"""Online SCST from served traffic (the JAX package's ``rl/online.py``).

The serving engine is the actor. A live
:class:`~cst_captioning_tpu_torch.serving.engine.CaptionService` decodes
the same (1+K)-lane programs SCST trains on (lane 0 greedy, K sampled
lanes on the request's own seed); its ``feedback`` hook hands each
completed request's host tokens and logprobs to :meth:`on_result`, at no
extra launch. Full batches of ``rl.online_batch_size`` captures go through
a :class:`~cst_captioning_tpu_torch.rl.async_scst.RolloutRing`; the
learner scores them with the consensus reward (greedy lane as the
baseline) and applies the REINFORCE update, and every ``rl.swap_every``
updates it publishes its parameters back into the service
(:meth:`CaptionService.publish_params`), which swaps them in at its next
stride boundary without a drain.

**Staleness: drop-and-COUNT, never recount.** Served tokens are what a
live request received under the version that served it; decoding them
again would make up traffic that never happened. An entry whose version
lags the learner by more than ``rl.staleness_bound`` updates is dropped
and counted (``rl.online.dropped_stale``, the ``rl.online.staleness``
histogram). The drops are a function of (trace, swap schedule), so two
runs on one trace end with bit-identical learner parameters.

**Versions.** The learner's update counter is the version namespace:
each applied update bumps ``self.version``, a publish stamps the service
with it, and a request pins the version active at its encode. A batch
that straddles a swap takes its oldest capture's version.

**Parameters.** The learner updates ``state.model`` in place, on the
serving thread and its stream, between strides. ``publish_params`` loads
a copy, but the service's first model is the one it was built with, so
:meth:`OnlineSCSTTrainer.attach` refuses a learner whose parameters share
storage with the served model: its updates would change version 0's
weights under live traffic.

Observability (the JAX names): the ``rl.online.captured``,
``rl.online.batches``, ``rl.online.steps`` and ``rl.online.dropped_stale``
counters, the ``rl.online.staleness`` histogram, the
``rl.online.ring_occupancy`` gauge and the ``rl.online.step`` span; the
``rl_online_dropped`` and ``rl_online_step`` events go to ``on_event``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import RLConfig
from cst_captioning_tpu_torch.rl.async_scst import AsyncSCSTTrainer, RolloutRing
from cst_captioning_tpu_torch.rl.scst import SCSTTrainer
from cst_captioning_tpu_torch.train.state import TrainState


def _storages(model: torch.nn.Module) -> set[int]:
    return {p.untyped_storage().data_ptr() for p in model.parameters()}


class OnlineSCSTTrainer(SCSTTrainer):
    """SCSTTrainer fed by served traffic instead of a dataset epoch.

    The closed loop::

        trainer = OnlineSCSTTrainer(model, reward, cfg, state)
        svc = CaptionService(served_model, ...)
        trainer.attach(svc)          # feedback capture + publish target
        svc.serve(requests)          # captures -> ring -> updates -> swaps
        trainer.flush()              # consume what the ring still holds
        state = trainer.state

    ``state.model`` is the learner's own model (not the served one).
    ``ref_id`` maps a ``ClipRequest`` to the reward pool's video id
    (default: the request id, for requests named after their clips).
    """

    _STALE_BUCKETS = AsyncSCSTTrainer._STALE_BUCKETS

    def __init__(self, model, reward, cfg: RLConfig, state: TrainState, *,
                 max_len: int | None = None, ref_id: Callable | None = None,
                 guard: bool = False, stats: bool = False, on_event=None):
        super().__init__(model, reward, cfg, max_len=max_len, guard=guard,
                         stats=stats)
        self.state = state
        self.on_event = on_event or (lambda event, **fields: None)
        self._bound = max(0, int(cfg.staleness_bound))
        self._batch_size = max(1, int(cfg.online_batch_size))
        self._swap_every = max(1, int(cfg.swap_every))
        self._ref_id = ref_id or (lambda req: req.req_id)
        self._ring = RolloutRing(max(1, int(cfg.rollout_depth)))
        self._buffer: list[dict] = []
        self._service = None
        # the learner's update counter IS the parameter-version namespace
        self.version = 0
        # run ledgers the smoke run and the tests read back
        self.last_dropped = 0
        self.last_applied = 0
        self.last_staleness: dict[int, int] = {}
        self.history: list[dict] = []   # per-update metrics (reward trend)

    # ---- wiring -------------------------------------------------------------

    def attach(self, service, swap_every: int | None = None) -> None:
        """Bind a live ``CaptionService``: its completions feed
        :meth:`on_result`, and every ``swap_every``-th update publishes
        the learner's parameters into it.

        Needs a version-aligned service (a fresh one, or one whose active
        version equals the learner's), so admission stamps and the learner
        counter share one namespace, and a learner whose parameters do not
        share storage with the served model (module docstring)."""
        if service.param_version != self.version:
            raise ValueError(
                f"service param_version {service.param_version} != learner "
                f"version {self.version} — attach a fresh (or version-"
                "aligned) service so staleness arithmetic shares one counter")
        if _storages(service.model) & _storages(self.state.model):
            raise ValueError(
                "the learner's state.model shares parameter storage with "
                "the served model: its in-place updates would change the "
                "served version's weights under live traffic — train a "
                "copy (copy.deepcopy) of the served model")
        if swap_every is not None:
            self._swap_every = max(1, int(swap_every))
        self._service = service
        service._feedback = self.on_result

    # ---- the feedback capture (CaptionService hook) -------------------------

    def on_result(self, req, result, param_version: int) -> None:
        """Feedback hook: one completed request becomes one rollout row.
        ``result.tokens`` / ``logprobs`` are the host arrays the service
        already read back."""
        K = self.cfg.num_rollouts
        if result.tokens.shape[0] != 1 + K:
            raise ValueError(
                f"served request {req.req_id!r} has "
                f"{result.tokens.shape[0]} lanes; the online learner is "
                f"configured for 1+K={1 + K}")
        self._buffer.append({
            "req_id": req.req_id,
            "seed": int(req.seed),
            "version": int(param_version),
            "video_id": self._ref_id(req),
            "greedy": np.asarray(result.tokens[0], np.int32),
            "samples": np.asarray(result.tokens[1:], np.int32),
            "lps": np.asarray(result.logprobs[1:], np.float32),
            "feats": req.feats,
            "masks": req.masks,
        })
        obs.counter("rl.online.captured").inc()
        if len(self._buffer) >= self._batch_size:
            self._push_batch()
        while len(self._ring) >= self._ring.depth:
            self._consume_one()

    @property
    def pending_captures(self) -> int:
        """Captures buffered toward the next (not yet full) batch."""
        return len(self._buffer)

    def flush(self) -> int:
        """Consume every complete batch still in the ring (end of trace,
        before a drain) -> how many. A partial capture buffer stays: batch
        shapes through the ring are constant, and more traffic may land."""
        n = 0
        while len(self._ring):
            self._consume_one()
            n += 1
        return n

    # ---- batch forming ------------------------------------------------------

    def _push_batch(self) -> None:
        """Form a learner batch from the oldest captures: frames padded to
        ``max_frames``, every modality's features and masks packed into
        one host buffer and copied to the learner's device at once."""
        batch, self._buffer = (self._buffer[:self._batch_size],
                               self._buffer[self._batch_size:])
        cfg = self.model.cfg
        F = cfg.max_frames
        parts, shapes = [], []
        for name, _ in cfg.modalities:
            for key in ("feats", "masks"):
                rows = []
                for cap in batch:
                    x = np.asarray(cap[key][name], np.float32)
                    pad = ((0, F - x.shape[0]),) + ((0, 0),) * (x.ndim - 1)
                    rows.append(np.pad(x, pad))
                arr = np.stack(rows)
                shapes.append((name, key, arr.shape))
                parts.append(arr.ravel())
        dev = self.state.model.device
        flat = torch.from_numpy(np.concatenate(parts)).to(dev)
        feats: dict[str, torch.Tensor] = {}
        masks: dict[str, torch.Tensor] = {}
        at = 0
        for name, key, shape in shapes:
            n = int(np.prod(shape))
            (feats if key == "feats" else masks)[name] = \
                flat[at:at + n].view(shape)
            at += n
        greedy = torch.from_numpy(
            np.stack([cap["greedy"] for cap in batch]))             # [B, T]
        samples = torch.from_numpy(
            np.stack([cap["samples"] for cap in batch], axis=1))    # [K, B, T]
        lps = torch.from_numpy(
            np.stack([cap["lps"] for cap in batch], axis=1))
        self._ring.push(
            greedy, samples, lps, device=dev,
            # a mixed-version batch is as stale as its OLDEST capture
            version=min(cap["version"] for cap in batch),
            feats=feats, masks=masks,
            video_ids=[cap["video_id"] for cap in batch],
            valid_np=np.ones((len(batch),), np.float32),
            req_ids=[cap["req_id"] for cap in batch],
            seeds=[cap["seed"] for cap in batch],
            # the score reads the served tokens from the host
            host=((greedy, None), (samples, None)))
        obs.counter("rl.online.batches").inc()
        obs.gauge("rl.online.ring_occupancy").set(float(len(self._ring)))

    # ---- consumption --------------------------------------------------------

    def _consume_one(self) -> None:
        meta, greedy, samples, lps = self._ring.pop()
        stale = self.version - meta["version"]
        self.last_staleness[stale] = self.last_staleness.get(stale, 0) + 1
        obs.histogram("rl.online.staleness", self._STALE_BUCKETS).observe(
            float(stale))
        if stale > self._bound:
            # drop-and-COUNT: nothing to recount (module docstring)
            self.last_dropped += 1
            obs.counter("rl.online.dropped_stale").inc()
            self.on_event("rl_online_dropped", staleness=stale,
                          version=meta["version"], req_ids=meta["req_ids"])
            return
        # the serve loop runs under no_grad; the update needs its gradients
        with obs.span("rl.online.step"), torch.enable_grad():
            scored = self._score(greedy, samples, meta["feats"],
                                 meta["masks"], meta["video_ids"],
                                 meta["valid_np"], host=meta["host"])
            self.state, m = self._apply(self.state, *scored)
        self.version += 1
        self.last_applied += 1
        obs.counter("rl.online.steps").inc()
        m = dict(m, staleness=stale, param_version=self.version)
        self.history.append(m)
        self.on_event("rl_online_step", **{
            k: m[k] for k in ("reward_mean", "staleness", "param_version")
            if k in m})
        if self._service is not None and self.version % self._swap_every == 0:
            # version-stamped publish; the service swaps it in at its next
            # stride boundary, without a drain
            self._service.publish_params(self.state.model,
                                         version=self.version)
