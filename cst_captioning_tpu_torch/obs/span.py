"""Nested wall-clock tracing spans + the run-level obs recorder.

One process-global :class:`ObsRecorder` (installed by :func:`configure`,
normally from the Trainer or a CLI) owns the run's observability outputs:

- ``<dir>/events.jsonl`` — every finished span and every metrics snapshot as
  one JSON line (the input to ``cli.obs_report``), line-buffered so a killed
  run still has its stream;
- ``<dir>/trace.json``   — the same spans in Chrome/Perfetto trace-event
  format (load in https://ui.perfetto.dev), one track per thread plus named
  virtual tracks (the profiler window);
- ``<dir>/metrics.prom`` — the registry in Prometheus textfile format,
  rewritten on every snapshot (point a node_exporter textfile collector at
  the run dir).

``with span("rl.decode"):`` costs two ``perf_counter`` calls plus one dict +
one JSONL line when enabled; when no recorder is installed it returns a
shared no-op object — one global load and an identity check, so hot paths
keep their instrumentation unconditionally. Spans never read device values
(wall clock only): no ``torch.cuda.synchronize``, no CUDA event, no
``.item()``, so instrumentation adds zero host syncs by construction. A
span around asynchronous CUDA work therefore measures the host's dispatch
window (plus whatever sync the wrapped code makes itself), not the
device's time.

A thread-local context carries run-position fields (``phase``/``epoch``/
``step`` via :func:`set_context`) onto every event emitted by that thread;
a thread-local span stack provides nesting depth, parent names, and exact
self-time (parent duration minus time spent in child spans), which is what
lets the report's per-phase totals partition wall clock without double
counting.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any

from cst_captioning_tpu_torch.obs import metrics as _metrics

_TLS = threading.local()


def wall_time() -> float:
    """Epoch-seconds "now": the obs spelling for wall-clock timestamps.
    Event streams and the flight recorder stamp through here."""
    return time.time()


def _ctx() -> dict:
    d = getattr(_TLS, "ctx", None)
    if d is None:
        d = _TLS.ctx = {}
    return d


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


def set_context(**fields: Any) -> None:
    """Attach run-position fields (phase/epoch/step/...) to every event this
    thread emits; a value of ``None`` removes the field. No-op cheapness is
    the caller's concern — guard with :func:`enabled` in per-step loops."""
    d = _ctx()
    for k, v in fields.items():
        if v is None:
            d.pop(k, None)
        else:
            d[k] = v


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    begin = __enter__

    def end(self) -> None:
        pass


_NOOP = _NoopSpan()


class Span:
    """One timed window. Use as a context manager, or via ``begin()`` /
    ``end()`` for windows that don't nest lexically (the profiler trace
    window). ``track`` puts the span on a named virtual timeline track and
    keeps it out of the thread's nesting stack — for exactly those
    improperly-nested windows."""

    __slots__ = ("rec", "name", "track", "attrs", "_t0", "_child")

    def __init__(self, rec: "ObsRecorder", name: str, track: str | None,
                 attrs: dict):
        self.rec = rec
        self.name = name
        self.track = track
        self.attrs = attrs
        self._t0 = 0.0
        self._child = 0.0  # seconds spent in child spans

    def begin(self) -> "Span":
        if self.track is None:
            _stack().append(self)
        self._t0 = time.perf_counter()
        return self

    __enter__ = begin

    def end(self) -> None:
        t1 = time.perf_counter()
        dur = t1 - self._t0
        parent = None
        if self.track is None:
            stack = _stack()
            # tolerate a foreign stack state (a begin() without end() above
            # us): pop down to self so accounting degrades, never corrupts
            while stack:
                top = stack.pop()
                if top is self:
                    break
            if stack:
                parent = stack[-1]
                parent._child += dur
        self.rec.record_span(
            name=self.name,
            t0=self._t0,
            dur=dur,
            self_dur=max(dur - self._child, 0.0),
            depth=len(_stack()) if self.track is None else 0,
            parent=parent.name if parent is not None else None,
            track=self.track,
            attrs=self.attrs,
        )

    def __exit__(self, *exc) -> None:
        self.end()


class ObsRecorder:
    """Owns the run's event stream, trace buffer, and metric snapshots."""

    def __init__(self, out_dir: str, run: str = "run",
                 snapshot_every: int = 0):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.run = run
        self.snapshot_every = snapshot_every
        self._t_origin = time.perf_counter()  # trace timestamp origin
        self._lock = threading.Lock()
        self._trace: list[dict] = []
        self._closed = False
        self._fh = open(os.path.join(out_dir, "events.jsonl"), "a",
                        buffering=1)
        self._atexit = self.close
        atexit.register(self._atexit)
        # the configuring thread is the run's foreground timeline: the
        # report partitions wall clock over ITS spans only (background
        # threads overlap it and are listed separately)
        self.main_thread = threading.current_thread().name
        # read once: os.getpid() is a system call, which a virtualised
        # host can charge tens of microseconds a span for
        self.pid = os.getpid()
        self.emit("run_start", run=run, pid=self.pid,
                  thread=self.main_thread)

    # ---- event stream -------------------------------------------------------

    def emit(self, event: str, **fields: Any) -> None:
        rec = {"ts": wall_time(), "event": event, **_ctx(), **fields}
        with self._lock:
            if self._closed:
                return
            self._fh.write(json.dumps(rec, default=float) + "\n")

    def record_span(self, name: str, t0: float, dur: float, self_dur: float,
                    depth: int, parent: str | None, track: str | None,
                    attrs: dict) -> None:
        thread = threading.current_thread().name
        fields = {
            "name": name,
            "dur": round(dur, 6),
            "self_dur": round(self_dur, 6),
            "depth": depth,
            "thread": thread,
        }
        if parent:
            fields["parent"] = parent
        if track:
            fields["track"] = track
        for k, v in attrs.items():
            # span attrs must not shadow the span schema (a span attribute
            # literally named "name"/"dur"/... gets an attr_ prefix)
            fields[("attr_" + k) if k in fields else k] = v
        self.emit("span", **fields)
        tid = track or thread
        ev = {
            "name": name,
            "ph": "X",
            "ts": round((t0 - self._t_origin) * 1e6, 1),
            "dur": round(dur * 1e6, 1),
            "pid": self.pid,
            "tid": tid,
        }
        if attrs:
            ev["args"] = attrs
        with self._lock:
            if not self._closed:
                self._trace.append(ev)

    # ---- metrics ------------------------------------------------------------

    def snapshot(self, **fields: Any) -> None:
        """Snapshot the process-wide registry into the event stream (plus the
        Prometheus textfile), refreshing the device-memory gauges first."""
        _metrics.observe_device_memory()
        snap = _metrics.snapshot()
        self.emit("metrics", **fields, **snap)
        self.write_prometheus()

    def maybe_snapshot(self, step: int) -> None:
        """Cadenced snapshot: fires when ``step`` hits ``snapshot_every``."""
        if self.snapshot_every and step % self.snapshot_every == 0:
            self.snapshot(step=step)

    def write_prometheus(self) -> None:
        text = _metrics.REGISTRY.to_prometheus()
        tmp = os.path.join(self.out_dir, ".metrics.prom.tmp")
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(self.out_dir, "metrics.prom"))

    def write_trace(self) -> None:
        with self._lock:
            events = list(self._trace)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        tmp = os.path.join(self.out_dir, ".trace.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(self.out_dir, "trace.json"))

    # ---- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        if self._atexit is not None:
            atexit.unregister(self._atexit)
            self._atexit = None
        self.snapshot(final=True)
        self.emit("run_end", run=self.run)
        self.write_trace()
        with self._lock:
            self._closed = True
            self._fh.flush()
            self._fh.close()


_RECORDER: ObsRecorder | None = None


def configure(out_dir: str, run: str = "run", enabled: bool = True,
              snapshot_every: int = 0) -> ObsRecorder | None:
    """Install the process-global recorder (closing any previous one).

    ``enabled=False`` is a no-op returning None — callers thread their
    config flag straight through — it deliberately does NOT tear down a
    recorder another owner installed."""
    global _RECORDER
    if not enabled:
        return None
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = ObsRecorder(out_dir, run=run, snapshot_every=snapshot_every)
    return _RECORDER


def shutdown() -> None:
    """Finalize and uninstall the recorder (final snapshot, trace.json)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
        _RECORDER = None


def active() -> ObsRecorder | None:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def span(name: str, /, track: str | None = None, **attrs: Any):
    """A timed span: ``with span("rl.decode"): ...``. No-op when disabled.

    ``name`` is positional-only so an attribute called ``name`` stays a
    legal attr (it lands in the event as ``attr_name``)."""
    rec = _RECORDER
    if rec is None:
        return _NOOP
    return Span(rec, name, track, attrs)


def event(name: str, **fields: Any) -> None:
    """Emit one structured event into the obs stream (no-op when disabled)."""
    rec = _RECORDER
    if rec is not None:
        rec.emit(name, **fields)


def snapshot_metrics(**fields: Any) -> None:
    """Force a metrics snapshot into the stream (no-op when disabled)."""
    rec = _RECORDER
    if rec is not None:
        rec.snapshot(**fields)


def maybe_snapshot(step: int) -> None:
    """Cadenced snapshot per the recorder's configured interval."""
    rec = _RECORDER
    if rec is not None:
        rec.maybe_snapshot(step)
