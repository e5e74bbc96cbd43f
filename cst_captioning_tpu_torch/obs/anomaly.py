"""Online anomaly detection over training-dynamics scalar streams.

The flight recorder (:mod:`obs.recorder`) feeds every flushed step's scalars
through one :class:`AnomalyDetector`; the divergence sentinel
(:mod:`resilience.sentinel`) reports its verdicts through the same
:func:`record_anomaly` spelling — so rollback decisions, the postmortem
timeline, and the ``obs.anomaly.<kind>`` counters all agree on what an
anomaly is called and how it is counted.

Detection model (pure stdlib, O(1) per observation):

- per-stream **EWMA z-score**: exponentially-weighted mean/variance
  (``alpha`` — the effective memory is ~``2/alpha`` steps) updated online;
  once ``warmup`` observations are in, a value more than ``z_threshold``
  EW-standard-deviations from the EW-mean is flagged. Flagged values still
  update the moments (a level shift re-converges instead of alarming
  forever).
- **nonfinite**: NaN/inf observations short-circuit to their own kind —
  they would poison the moments and are categorically worse than a spike.
- **stall**: the recorder timestamps each step on the host; a gap exceeding
  ``stall_factor`` x the p95 of the recent-gap window means no step
  completed within the budget (a wedged prefetch thread, a hung collective,
  a dead reward service).

Anomaly kinds currently emitted: ``nonfinite``, ``spike`` (the sentinel's
median-based loss-spike policy), ``stall``, ``slo_burn`` (serving), and
``<stream>_z`` for each z-score stream (``step_time_z``, ``grad_norm_z``,
``reward_z``, ``loss_z``).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any

from cst_captioning_tpu_torch.obs import metrics as _metrics
# name import, not `obs import span`: the obs package re-exports the span()
# context-manager FUNCTION under that name, shadowing the submodule
from cst_captioning_tpu_torch.obs.span import event as _span_event


def record_anomaly(kind: str, **fields: Any) -> None:
    """THE anomaly spelling: one structured ``anomaly`` event on the obs
    stream plus the ``obs.anomaly.<kind>`` counter. Every producer — the
    recorder's online detectors, the divergence sentinel, the serving SLO
    burn-rate monitor — reports through here so reports and dashboards
    aggregate one vocabulary."""
    _metrics.counter(f"obs.anomaly.{kind}").inc()
    _span_event("anomaly", kind=kind, **fields)


class Ewma:
    """Exponentially-weighted mean/variance with a warmup gate.

    :meth:`update` returns the observation's z-score against the moments
    *before* it was folded in (``None`` until ``warmup`` observations are
    seen — early z-scores against a 1-sample variance are noise)."""

    __slots__ = ("alpha", "warmup", "n", "mean", "var")

    def __init__(self, alpha: float = 0.1, warmup: int = 8):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} must be in (0, 1]")
        self.alpha = alpha
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> float | None:
        z = None
        if self.n >= self.warmup and self.var > 0.0:
            z = (x - self.mean) / math.sqrt(self.var)
        if self.n == 0:
            self.mean = x
        else:
            a = self.alpha
            d = x - self.mean
            self.mean += a * d
            # West's EW variance update: unbiased enough for thresholding
            self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1
        return z


class AnomalyDetector:
    """z-score detectors over named scalar streams + the step-gap stall
    detector. :meth:`observe` returns the list of anomaly kinds the value
    tripped (empty when healthy) and reports each via
    :func:`record_anomaly`."""

    # streams the recorder routes through the z-score detectors; everything
    # else in a step record is carried but not judged
    STREAMS = ("step_time", "grad_norm", "reward", "loss")

    def __init__(self, z_threshold: float = 4.0, alpha: float = 0.1,
                 warmup: int = 8, stall_factor: float = 10.0,
                 gap_window: int = 64):
        self.z_threshold = z_threshold
        self.stall_factor = stall_factor
        self._ewma = {s: Ewma(alpha=alpha, warmup=warmup)
                      for s in self.STREAMS}
        self._gaps: deque[float] = deque(maxlen=gap_window)

    def ewma(self, stream: str) -> Ewma:
        """The live :class:`Ewma` behind ``stream`` (the JAX package's
        adaptive spike bound reads these moments; in the port that bound
        comes with the resilience slice)."""
        return self._ewma[stream]

    def observe(self, stream: str, value: float, *, step: int = -1,
                phase: str = "") -> list[str]:
        """Judge one observation of ``stream``. Unknown streams are carried
        without judgment (the recorder records more than it detects on)."""
        ew = self._ewma.get(stream)
        if ew is None:
            return []
        if not math.isfinite(value):
            record_anomaly("nonfinite", stream=stream, step=step, phase=phase,
                           value=value)
            return ["nonfinite"]
        z = ew.update(value)
        if z is not None and abs(z) > self.z_threshold:
            kind = f"{stream}_z"
            record_anomaly(kind, stream=stream, step=step, phase=phase,
                           value=value, z=z)
            return [kind]
        return []

    def observe_gap(self, gap_s: float, *, step: int = -1,
                    phase: str = "") -> list[str]:
        """Feed one host-side step-completion gap; flags a stall when the
        gap exceeds ``stall_factor`` x the p95 of the recent-gap window."""
        out: list[str] = []
        if len(self._gaps) >= 8:
            ordered = sorted(self._gaps)
            p95 = ordered[min(int(0.95 * len(ordered)), len(ordered) - 1)]
            if p95 > 0.0 and gap_s > self.stall_factor * p95:
                record_anomaly("stall", step=step, phase=phase, gap_s=gap_s,
                               p95_s=p95)
                out.append("stall")
        self._gaps.append(gap_s)
        return out
