"""Unified observability: tracing spans, metrics registry, run reports.

The subsystem threaded through trainer/SCST/evaluator/prefetch/ckpt/
resilience (README "Observability"):

- :mod:`obs.span`    — nested wall-clock spans + the run recorder
  (``events.jsonl``, Perfetto ``trace.json``); ``obs.span("rl.decode")`` is
  a no-op identity check when no recorder is configured.
- :mod:`obs.metrics` — process-wide counters/gauges/histograms, snapshotted
  into the event stream on the ``train.log_every_steps`` cadence and
  exported as a Prometheus textfile.
- :mod:`obs.report`  — aggregates a run dir into the phase-breakdown +
  resilience report behind ``python -m cst_captioning_tpu_torch.cli.obs_report``.
- :mod:`obs.recorder` — the training-dynamics flight recorder: a ring of
  per-step records flushed with one batched readback, dumped as a durable
  postmortem bundle when a run trips (README "Observability").
- :mod:`obs.anomaly` — online EWMA z-score + stall anomaly detection over
  the recorder's streams; every producer (recorder, divergence sentinel,
  serving SLO monitor) reports through ``anomaly.record_anomaly`` so the
  ``anomaly`` events and ``obs.anomaly.<kind>`` counters share one spelling.
- :mod:`obs.fleet` — merges the postmortem bundles of every process of a
  run dir onto one skew-corrected timeline (``--postmortem <run_dir>``).

The PyTorch port's copy of the JAX package's ``obs/``: the same event
stream, metric names, bundle layout and report, so each package's
``cli.obs_report`` renders the other's runs. Stdlib-only at import time
(torch is touched lazily, for the ``torch.cuda.memory_stats`` gauges and
the flight recorder's one readback a flush), and zero-sync by
construction: nothing in here reads a device value on the step path.
"""

from cst_captioning_tpu_torch.obs.metrics import (
    REGISTRY,
    StepMeter,
    counter,
    gauge,
    histogram,
    snapshot,
)
from cst_captioning_tpu_torch.obs.span import (
    ObsRecorder,
    Span,
    active,
    configure,
    enabled,
    event,
    maybe_snapshot,
    set_context,
    shutdown,
    snapshot_metrics,
    span,
    wall_time,
)

__all__ = [
    "REGISTRY",
    "ObsRecorder",
    "Span",
    "StepMeter",
    "active",
    "configure",
    "counter",
    "enabled",
    "event",
    "gauge",
    "histogram",
    "maybe_snapshot",
    "set_context",
    "shutdown",
    "snapshot",
    "snapshot_metrics",
    "span",
    "wall_time",
]
