"""Deterministic fault injection: seeded plans fired at named code points
(the JAX package's ``resilience/chaos.py``).

The hot paths call :func:`visit` at a handful of named points
(``"xe.step"``, ``"ckpt.save"``, ``"reward.call"``, ...). With no active
plan that is one module-global ``None`` check. A test activates a
:class:`FaultPlan`, and each of its :class:`Fault` fires at an exact visit
index of its point, so a chaos run is reproducible: the same plan kills the
same save, poisons the same batch, fails the same reward call.

Fault kinds (``Fault._KINDS``, the JAX tuple):

- ``"kill"``: raise :class:`SimulatedKill`, a ``BaseException``: it models
  a process death, so ``except Exception`` recovery must not swallow it.
- ``"preempt"``: send a real ``SIGTERM`` to this process (the trainer's
  :class:`~cst_captioning_tpu_torch.resilience.preempt.PreemptionHandler`
  path, not a flag).
- ``"io_error"``: raise :class:`TransientIOError` (an ``OSError``) for
  ``times`` visits from ``at``.
- ``"nan"``: poison the visited payload (a ``data.batcher.Batch``): every
  feature array becomes NaN, the labels stay valid.
- ``"slow"``, ``"slow_h2d"``, ``"wedged_prefetch"``: ``time.sleep(delay)``
  (a stalled reward service, a degraded host-to-device copy at
  ``prefetch.h2d``, a wedged prefetch worker at ``prefetch.stage``).
- ``"partial_h2d"``: raise :class:`PartialTransferError`: the staged batch
  never fully landed on the device; prefetch redoes the placement.
- ``"enospc_rotation"``: raise ``OSError(ENOSPC)``: the disk filled up
  mid-checkpoint; rotation reclaims the oldest generation and retries.
- ``"serving_preempt"``: ask the serving ``CaptionService`` to drain (fire
  at ``serving.step``).
- ``"param_swap"``: a drain landing exactly at the hot swap (fire at
  ``serving.param_swap``): the swap is refused and the drained snapshot
  replays under the old version, never a torn one.
- ``"actor_preempt"``: preempt one actor rank of the decoupled RL
  trainer (fire at ``rl.actor.step``; ``host`` indexes the victim in the
  current actor set). The rank is shed, not killed: it stays alive and
  idle.
- ``"host_rejoin"`` at ``rl.actor.step``: re-admit a shed actor rank
  (``host`` indexes the initial actor set). Across ranks the epoch agrees
  on both at each batch boundary, in one exchange over the world: the
  requests of the lowest rank holding any land on every rank, so the same
  seeded plan run on every rank (each rank visits ``rl.actor.step`` once a
  batch) counts once, and a request made on one rank alone lands on all.
- ``"partial_preempt"``: lose peer ``host`` on the active
  :class:`~cst_captioning_tpu_torch.resilience.health.HealthMonitor`
  (``health.simulate_peer_loss``: a tombstone and the ``peer_lost`` flag,
  which the trainer and the serve loop drain on).
- ``"host_rejoin"`` / ``"host_rejoin_flaky"`` anywhere but
  ``rl.actor.step`` (the JAX tests fire them at ``health.rejoin``): the
  lost peer ``host`` recovers on the active monitor
  (``health.simulate_rejoin``; flaky: it announces itself and never checks
  into the regrow rendezvous). When the hosts are real processes
  ``host_rejoin`` raises, naming the host to restart; the flaky kind still
  leaves its marker and heartbeat, so the survivors' regrow rendezvous
  times out.

Points in the port (the JAX names):

=======================  =================================================
``xe.step``              XE loop, once per dispatched step (main thread)
``xe.batch``             XE batch prep, payload = the ``Batch`` (prefetch)
``rl.step``              RL loop, once per completed step (main thread)
``rl.batch``             RL batch prep, payload = the ``Batch`` (prefetch)
``prefetch.stage``       prefetch worker, once per staged item
``prefetch.h2d``         inside the retried host-to-device placement
``ckpt.save``            entry of ``save_state``
``ckpt.state_written``   after ``state.npz`` hits the tmp dir
``ckpt.pre_replace``     tmp dir complete and fsync'd, before the swap
``reward.call``          inside the retried RL reward call
``serving.step``         serving loop, once per iteration
``serving.param_swap``   between a staged publish and its application
``rl.actor.step``        decoupled actor loop, once per batch
``health.rejoin``        the degraded trainer's rejoin poll, once per
                         batch boundary while a host is lost
=======================  =================================================

Each firing counts on ``resilience.chaos_fault`` and
``resilience.chaos_fault.<kind>`` and, before the fault acts, dumps a
flight-recorder postmortem (``obs.recorder.note_fault``). Serving and RL
are imported only when a fault needs them, so ``cli.obs_report`` can import
this module without them.
"""

from __future__ import annotations

import errno
import os
import signal
import threading
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np

from cst_captioning_tpu_torch.obs import metrics as obs_metrics
from cst_captioning_tpu_torch.resilience import health

class SimulatedKill(BaseException):
    """A chaos-injected process death. A BaseException on purpose: code
    that catches ``Exception`` must not survive a kill."""


class TransientIOError(OSError):
    """A chaos-injected transient I/O failure (retryable)."""


class PartialTransferError(TransientIOError):
    """A chaos-injected partial host-to-device transfer (retryable): the
    destination is torn, the placement must be redone."""


@dataclass
class Fault:
    """One scheduled fault.

    ``at`` is the 0-based visit index of ``point`` that triggers it;
    ``("rand", lo, hi)`` has :class:`FaultPlan` draw it from the plan's
    seed. ``times`` widens the fault to that many consecutive visits.
    ``host`` names the victim of a ``partial_preempt`` / ``actor_preempt``
    and the rejoiner of a ``host_rejoin``.
    """

    point: str
    kind: str
    at: Any = 0
    times: int = 1
    delay: float = 0.0
    host: int = 0

    _KINDS = ("kill", "preempt", "io_error", "nan", "slow", "slow_h2d",
              "partial_h2d", "wedged_prefetch", "enospc_rotation",
              "partial_preempt", "serving_preempt", "actor_preempt",
              "host_rejoin", "host_rejoin_flaky", "param_swap")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.times < 1:
            raise ValueError(f"fault times {self.times} must be >= 1")

    def window(self) -> range:
        return range(self.at, self.at + self.times)


class FaultPlan:
    """A seeded schedule of faults, activated as a context manager::

        plan = FaultPlan([Fault("xe.step", "preempt", at=7)], seed=3)
        with plan.activate():
            trainer.train_xe()
        plan.fired  # [{"point": "xe.step", "kind": "preempt", "visit": 7}]

    One plan can be active per process at a time (they model process-level
    failures). ``fired`` records every triggered fault in order."""

    def __init__(self, faults: list[Fault], seed: int = 0):
        rng = np.random.default_rng(seed)
        self.seed = seed
        self.faults: list[Fault] = []
        for f in faults:
            if isinstance(f.at, tuple):
                tag, lo, hi = f.at
                if tag != "rand":
                    raise ValueError(f"bad fault at-spec {f.at!r}")
                f = replace(f, at=int(rng.integers(lo, hi)))
            self.faults.append(f)
        self.fired: list[dict] = []
        self._visits: dict[str, int] = {}
        self._lock = threading.Lock()

    def activate(self) -> "_Activation":
        return _Activation(self)

    def visits(self, point: str) -> int:
        with self._lock:
            return self._visits.get(point, 0)

    def _visit(self, point: str, payload: Any) -> Any:
        with self._lock:
            idx = self._visits.get(point, 0)
            self._visits[point] = idx + 1
            due = [f for f in self.faults
                   if f.point == point and idx in f.window()]
            for f in due:
                self.fired.append({"point": point, "kind": f.kind,
                                   "visit": idx})
                obs_metrics.counter("resilience.chaos_fault").inc()
                obs_metrics.counter(f"resilience.chaos_fault.{f.kind}").inc()
        if due:
            # the postmortem before the fault acts: a kill or a preempt
            # unwinds past any later dump site
            from cst_captioning_tpu_torch.obs import recorder as obs_recorder

            for f in due:
                if f.kind == "partial_preempt":
                    extra = {"victim_host": f.host}
                elif f.kind in ("host_rejoin", "host_rejoin_flaky"):
                    extra = {"rejoiner_host": f.host}
                else:
                    extra = {}
                obs_recorder.note_fault(point, f.kind, visit=idx, **extra)
        # fire outside the lock: sleeps must not serialize the threads
        for f in due:
            if f.kind == "kill":
                raise SimulatedKill(f"chaos kill at {point}#{idx}")
            if f.kind == "io_error":
                raise TransientIOError(f"chaos io_error at {point}#{idx}")
            if f.kind == "partial_h2d":
                raise PartialTransferError(
                    f"chaos partial_h2d at {point}#{idx}")
            if f.kind == "enospc_rotation":
                raise OSError(
                    errno.ENOSPC,
                    f"chaos enospc at {point}#{idx}: No space left on device")
            if f.kind == "preempt":
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "partial_preempt":
                health.simulate_peer_loss(f.host)
            elif f.kind in ("serving_preempt", "param_swap"):
                # a param_swap drain lands at the swap seam, before
                # anything mutates, so the service refuses the publish
                from cst_captioning_tpu_torch.serving import engine

                engine.request_drain(f"chaos_{f.kind}")
            elif f.kind == "actor_preempt":
                from cst_captioning_tpu_torch.rl import async_scst

                async_scst.request_actor_preempt(f.host)
            elif f.kind in ("host_rejoin", "host_rejoin_flaky"):
                if point == "rl.actor.step":
                    # the actor fleet: re-admit a shed actor device
                    from cst_captioning_tpu_torch.rl import async_scst

                    async_scst.request_actor_rejoin(f.host)
                else:
                    health.simulate_rejoin(
                        f.host, flaky=(f.kind == "host_rejoin_flaky"))
            elif f.kind in ("slow", "slow_h2d", "wedged_prefetch"):
                time.sleep(f.delay)
            elif f.kind == "nan":
                payload = _poison(payload)
        return payload


@dataclass
class _Activation:
    plan: FaultPlan

    def __enter__(self) -> FaultPlan:
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("another FaultPlan is already active")
        _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


_ACTIVE: FaultPlan | None = None


def _poison(payload: Any) -> Any:
    """NaN-poison a batch payload in place: the features only, so the
    loss, not the integer pipeline, is what diverges."""
    if payload is None:
        raise ValueError("nan fault fired at a point with no batch payload")
    feats = getattr(payload, "feats", payload)
    for arr in feats.values() if hasattr(feats, "values") else [feats]:
        arr[:] = np.nan
    return payload


def visit(point: str, payload: Any = None) -> Any:
    """Injection point: returns ``payload`` unless a plan is active and
    schedules a fault at this visit of ``point``."""
    if _ACTIVE is None:
        return payload
    return _ACTIVE._visit(point, payload)
