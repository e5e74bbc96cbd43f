"""The adaptive spike bound: the anomaly detector's moments become the
divergence sentinel's bound (the JAX package's ``resilience/adaptive.py``).

The fixed policy trips when ``loss > spike_factor * median(recent)``; a
factor loose enough for healthy noise misses a slow ramp, whose median
creeps up with it. An EWMA of the loss (memory about ``2 / alpha`` steps)
sits many standard deviations below the early ramp steps before its
moments catch up, so :class:`AdaptiveThresholds` sets::

    bound = clamp(mean + z * std,  spike_factor_min * median,
                                   spike_factor     * median)

- The upper clamp keeps adaptive mode at least as strict as the fixed
  factor.
- The lower clamp keeps a very quiet healthy phase from tripping on noise.
- Until the EWMA has ``warmup`` observations and a nonzero variance the
  fixed bound is used as it is.

With the anomaly detector live (``train.anomaly``) its ``loss``
:class:`~cst_captioning_tpu_torch.obs.anomaly.Ewma` is shared and only
read here (the detector updates it at the recorder's flushes); without one
the instance owns a private ``Ewma`` fed from the sentinel's checks. All of
it is host arithmetic on values the sentinel has already read back, and
``spike_mode="fixed"`` never builds this class.
"""

from __future__ import annotations

import math

from cst_captioning_tpu_torch.obs.anomaly import Ewma


class AdaptiveThresholds:
    """EWMA-moment spike bound for
    :class:`~cst_captioning_tpu_torch.resilience.sentinel.DivergenceSentinel`.

    ``factor_max`` is the config's ``spike_factor`` (the ceiling clamp),
    ``factor_min`` its ``spike_factor_min`` (the floor clamp). ``z``: the
    bound's distance above the EW mean in EW standard deviations; 3, tighter
    than the detector's 4, so a ramp trips at onset before the shared
    moments chase it. ``ewma``: a live ``Ewma`` to share, else a private
    one fed by :meth:`observe`.
    """

    def __init__(self, factor_max: float, factor_min: float = 1.5,
                 z: float = 3.0, ewma: Ewma | None = None,
                 alpha: float = 0.1, warmup: int = 8):
        if factor_max <= 0.0:
            raise ValueError(f"factor_max {factor_max} must be > 0")
        if not 0.0 < factor_min <= factor_max:
            raise ValueError(
                f"factor_min {factor_min} must be in (0, factor_max="
                f"{factor_max}]")
        if z <= 0.0:
            raise ValueError(f"z {z} must be > 0")
        self.factor_max = factor_max
        self.factor_min = factor_min
        self.z = z
        self._shared = ewma is not None
        self.ewma = ewma if ewma is not None else Ewma(alpha=alpha,
                                                       warmup=warmup)

    @property
    def warmed(self) -> bool:
        """The moments are trusted over the fixed bound."""
        ew = self.ewma
        return ew.n >= max(ew.warmup, 2) and ew.var > 0.0

    def observe(self, loss: float) -> None:
        """Fold one checked, finite loss into the moments; a no-op when
        shared (the detector owns the updates, and counting twice would
        halve the memory)."""
        if not self._shared and math.isfinite(loss):
            self.ewma.update(loss)

    def bound(self, median: float, fixed_bound: float) -> float:
        """The bound this check's loss is held to: ``fixed_bound``
        (``spike_factor * median``) until warmed; the clamps apply while
        the median is positive (an RL loss can be negative, where a factor
        of the median means nothing: there the EWMA bound, still capped at
        ``fixed_bound``)."""
        if not self.warmed:
            return fixed_bound
        b = self.ewma.mean + self.z * math.sqrt(self.ewma.var)
        if median > 0.0:
            b = max(b, self.factor_min * median)
        return min(b, fixed_bound)
