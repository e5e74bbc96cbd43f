"""The divergence sentinel over the step loops (the JAX package's
``resilience/sentinel.py``).

The finite-update guard (``train.state.guarded_apply_gradients``) already
keeps a non-finite update out of the state; the sentinel is the policy on
top. It buffers each step's ``(loss, nonfinite)`` and checks them at
:meth:`flush` (or every ``check_every`` steps), then

- logs every divergence as a ``divergence`` event,
- under ``policy="skip_batch"`` carries on (the guard did the work),
- under ``policy="rollback"`` raises :class:`RollbackRequested`, so the
  trainer restores the last good checkpoint under a new data order,
- under ``policy="abort"`` raises :class:`TrainingDiverged`.

A loss spike (finite, above ``spike_factor`` times the recent median) is
found on the same check; its update is applied already, so ``skip_batch``
only logs it. ``adaptive=`` (``train.spike_mode="adaptive"``) takes the
bound from an :class:`~cst_captioning_tpu_torch.resilience.adaptive.AdaptiveThresholds`
instead (``resilience/adaptive.py``); without it the fixed policy runs as
it is.

Every verdict also goes through ``obs.anomaly.record_anomaly`` (the
``obs.anomaly.<kind>`` counter and an ``anomaly`` event, the spelling the
online detector uses), counts on ``resilience.divergence.<kind>`` (and a
skipped non-finite step on ``resilience.nan_skip``), and dumps a flight
recorder postmortem (``divergence_<kind>``) before any policy action.
"""

from __future__ import annotations

import math
import statistics
from collections import deque
from typing import Any, Callable

from cst_captioning_tpu_torch.obs import anomaly as obs_anomaly
from cst_captioning_tpu_torch.obs import metrics as obs_metrics
from cst_captioning_tpu_torch.obs import recorder as obs_recorder

POLICIES = ("off", "skip_batch", "rollback", "abort")


class TrainingDiverged(RuntimeError):
    """Raised under ``policy="abort"`` or past the rollback budget."""


class RollbackRequested(RuntimeError):
    """Caught by the trainer, which restores the last good checkpoint."""

    def __init__(self, message: str, step: int = -1, kind: str = ""):
        super().__init__(message)
        self.step = step
        self.kind = kind


class DivergenceSentinel:
    def __init__(self, policy: str = "skip_batch", phase: str = "xe",
                 log: Callable[..., None] | None = None,
                 spike_factor: float = 0.0, window: int = 32,
                 warmup: int = 8, check_every: int | None = None,
                 adaptive: Any = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown divergence policy {policy!r}")
        self.policy = policy
        self.phase = phase
        self.log = log or (lambda event, **fields: None)
        self.spike_factor = spike_factor
        self.warmup = warmup
        self.check_every = check_every
        self.adaptive = adaptive
        self._recent: deque[float] = deque(maxlen=window)
        self._buf: list[tuple[int, Any, Any]] = []
        self.skipped = 0

    def push(self, step: int, loss: Any, nonfinite: Any = None) -> None:
        """Record one step's scalars; checks them on the cadence."""
        if self.policy == "off":
            return
        self._buf.append((step, loss, nonfinite))
        if self.check_every is not None and len(self._buf) >= self.check_every:
            self.flush()

    def flush(self) -> None:
        """Check everything buffered, in step order."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        for step, loss, nonfinite in buf:
            self._check(int(step), float(loss), nonfinite)

    def reset(self) -> None:
        """Drop the buffer and the spike history (rollback)."""
        self._buf.clear()
        self._recent.clear()

    def _check(self, step: int, loss: float, nonfinite: Any) -> None:
        bad = bool(nonfinite) if nonfinite is not None else False
        if bad or not math.isfinite(loss):
            self._diverged(step, loss, "nonfinite")
            return
        if self.spike_factor and len(self._recent) >= self.warmup:
            med = statistics.median(self._recent)
            bound = self.spike_factor * med
            if self.adaptive is not None:
                bound = self.adaptive.bound(med, bound)
            if loss > bound:
                self._diverged(step, loss, "spike", bound=bound)
                return
        self._recent.append(loss)
        if self.adaptive is not None:
            self.adaptive.observe(loss)

    def _diverged(self, step: int, loss: float, kind: str,
                  bound: float | None = None) -> None:
        # skip_batch cannot take back a finite, spiked update: log only
        action = self.policy
        if kind == "spike" and self.policy == "skip_batch":
            action = "logged"
        detail = {} if bound is None else {"bound": bound}
        obs_metrics.counter(f"resilience.divergence.{kind}").inc()
        obs_anomaly.record_anomaly(kind, phase=self.phase, step=step,
                                   value=loss, source="sentinel", **detail)
        # capture the ring around the diverged step before the policy acts
        obs_recorder.postmortem(f"divergence_{kind}", phase=self.phase,
                                step=step, loss=loss, action=action,
                                **detail)
        self.log("divergence", phase=self.phase, step=step, loss=loss,
                 kind=kind, action=action, **detail)
        if self.policy == "skip_batch":
            if kind == "nonfinite":
                self.skipped += 1
                obs_metrics.counter("resilience.nan_skip").inc()
            return
        msg = f"{self.phase} step {step}: {kind} loss {loss!r}"
        if self.policy == "rollback":
            raise RollbackRequested(msg, step=step, kind=kind)
        raise TrainingDiverged(msg)
