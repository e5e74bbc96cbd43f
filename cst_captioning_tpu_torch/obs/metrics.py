"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only; torch is imported lazily and only for the
optional device-memory gauges), thread-safe (the prefetch worker and the
main step loop both write), and cheap: every metric is a couple of Python
float ops behind one registry-wide lock, with no device readback anywhere,
so the step loops' zero-sync contract holds by construction: nothing here
ever touches a tensor. The JAX package's module, copied: the same calls
give byte-equal snapshots and Prometheus text.

Three primitives, Prometheus-shaped so the textfile export is mechanical:

- :class:`Counter`   — monotonically increasing float (``inc``).
- :class:`Gauge`     — last-write-wins float (``set``).
- :class:`Histogram` — fixed upper-bound buckets chosen at creation
  (defaults tuned for step latencies); ``observe`` is two bisects and three
  adds, quantiles are interpolated from the buckets at read time.

The module-level :func:`counter`/:func:`gauge`/:func:`histogram` accessors
hit the default process-wide :class:`Registry` (``REGISTRY``) — the trainer,
SCST loop, evaluator, prefetch thread, and resilience layer all write to the
same registry, and the obs recorder snapshots it into the event stream.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Iterable

# step/IO latency buckets (seconds): 1ms .. 2min, roughly x2 per bucket
DEFAULT_TIME_BUCKETS = (
    0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5,
    1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# queue depths / small integer counts
DEFAULT_COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class Counter:
    """Monotonic counter (float increments allowed: accumulated seconds)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram over float observations.

    ``buckets`` are inclusive upper bounds in ascending order; observations
    above the last bound land in the implicit ``+Inf`` bucket. ``counts`` is
    cumulative-free (per-bucket); the Prometheus export cumulates. The exact
    ``max`` is tracked (p~100 from buckets alone is useless for tail spikes).
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Iterable[float] = DEFAULT_TIME_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name}: buckets must be distinct ascending bounds"
            )
        self.name = name
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1
        if value > self.max:
            self.max = value

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1] (Prometheus-style).

        Within the located bucket the mass is assumed uniform; the overflow
        bucket reports the exact observed ``max``.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                if i >= len(self.bounds):  # +Inf bucket
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return min(lo + (hi - lo) * frac, self.max if self.max else hi)
            seen += c
        return self.max

    def snapshot(self) -> dict[str, Any]:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "max": self.max,
        }


class Registry:
    """Name -> metric map with get-or-create accessors (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as a {m.kind}, "
                    f"requested as a {kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name), "gauge")

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, buckets), "histogram")

    def snapshot(self) -> dict[str, Any]:
        """One JSON-ready dict of every metric, grouped by kind."""
        with self._lock:
            out: dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, m in sorted(self._metrics.items()):
                out[m.kind + "s"][name] = m.snapshot()
            return out

    def reset(self) -> None:
        """Drop every metric (tests; a long-lived process never resets)."""
        with self._lock:
            self._metrics.clear()

    # ---- Prometheus textfile export ----------------------------------------

    def to_prometheus(self) -> str:
        """Render the registry in Prometheus text exposition format
        (node_exporter textfile-collector compatible)."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {m.kind}")
            if m.kind in ("counter", "gauge"):
                lines.append(f"{pname} {_prom_num(m.value)}")
                continue
            cum = 0
            for bound, c in zip(m.bounds, m.counts):
                cum += c
                lines.append(
                    f'{pname}_bucket{{le="{_prom_num(bound)}"}} {cum}'
                )
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {_prom_num(m.sum)}")
            lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_num(v: float) -> str:
    # Prometheus spells specials "NaN"/"+Inf"/"-Inf" (repr would emit "nan",
    # and int(inf) raises); integers render bare so counters read naturally
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f.is_integer() else repr(f)


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def snapshot() -> dict[str, Any]:
    return REGISTRY.snapshot()


# ---- device and build feeds (lazy torch, graceful everywhere) --------------

def observe_device_memory(registry: Registry | None = None) -> bool:
    """Update the memory watermark gauges for every visible CUDA device.

    Per device ``k``: ``device<k>.bytes_in_use`` /
    ``device<k>.peak_bytes_in_use`` (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.current`` and ``.peak``), ``device<k>.reserved_bytes``
    / ``device<k>.peak_reserved_bytes`` (``reserved_bytes.all.*``, what the
    caching allocator has reserved on the card) and ``device<k>.bytes_limit``
    (the card's total memory). The aggregate ``device.*`` gauges carry the
    max across devices.

    Returns False (and writes nothing) without a CUDA device or before the
    process has initialised CUDA, so callers never need to guard. The
    allocator counters are host-side bookkeeping: reading them launches
    nothing and waits for nothing.
    """
    reg = registry or REGISTRY
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return False
        per_dev = []
        for k in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(k)
            per_dev.append((k, {
                "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                "reserved_bytes": s.get("reserved_bytes.all.current", 0),
                "peak_reserved_bytes": s.get("reserved_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.get_device_properties(k)
                .total_memory,
            }))
    except Exception:
        return False
    if not per_dev:
        return False
    for key in per_dev[0][1]:
        reg.gauge(f"device.{key}").set(float(max(s[key] for _, s in per_dev)))
        for dev_id, stats in per_dev:
            reg.gauge(f"device{dev_id}.{key}").set(float(stats[key]))
    return True


def record_compile(seconds: float, registry: Registry | None = None) -> None:
    """Feed ``jit.compiles`` / ``jit.compile_seconds`` from a kernel build.

    The port has no jit compiler to listen to; its compiles are the nvcc
    builds of ``ops/build.py``. Each build that ran nvcc adds its seconds
    to ``jit.compile_seconds`` and one to ``jit.compiles``, so the run
    report's compile line reads "kernel builds" in the port (a library
    found already built adds nothing)."""
    reg = registry or REGISTRY
    reg.counter("jit.compile_seconds").inc(max(float(seconds), 0.0))
    reg.counter("jit.compiles").inc()


# ---- step meter (shared XE/RL epoch timing) ---------------------------------

class StepMeter:
    """Per-phase step latency + throughput on the process-wide registry.

    Both XE and RL epochs meter through this one class, so their latency
    accounting is identical by construction. ``tick(clips, first=True)``
    routes the first step (on the card it carries the kernel builds and the
    cuBLAS warm-up) into ``<phase>.compile_seconds`` instead of the latency
    histogram, keeping the throughput meter honest.

    Epoch summaries are windowed deltas over the cumulative metrics
    (:meth:`begin_epoch` marks, :meth:`epoch_summary` diffs), so the
    registry keeps whole-run totals while each epoch reports its own rate.
    """

    def __init__(self, phase: str, registry: Registry | None = None):
        reg = registry or REGISTRY
        self.phase = phase
        self.hist = reg.histogram(f"{phase}.step_seconds")
        self.compile_secs = reg.counter(f"{phase}.compile_seconds")
        self.clips = reg.counter(f"{phase}.clips")
        self.steps = reg.counter(f"{phase}.steps")
        self._t_last: float | None = None
        self._mark = (0.0, 0.0, 0)

    def begin_epoch(self) -> None:
        self._t_last = time.perf_counter()
        self._mark = (self.clips.value, self.hist.sum, self.hist.count)

    def tick(self, clips: int, first: bool = False) -> None:
        now = time.perf_counter()
        if self._t_last is None:  # begin_epoch not called: self-heal
            self._t_last = now
            return
        dur = now - self._t_last
        self._t_last = now
        if first:
            self.compile_secs.inc(dur)
            return
        self.hist.observe(dur)
        self.steps.inc()
        self.clips.inc(clips)

    def epoch_summary(self) -> dict[str, float]:
        clips0, sum0, count0 = self._mark
        d_clips = self.clips.value - clips0
        d_sum = self.hist.sum - sum0
        d_count = self.hist.count - count0
        return {
            "steps": float(d_count),
            "clips_per_sec": d_clips / d_sum if d_sum > 0 else 0.0,
            "step_seconds_p50": self.hist.quantile(0.5),
            "step_seconds_p95": self.hist.quantile(0.95),
        }
