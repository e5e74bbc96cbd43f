"""Black-box flight recorder: a ring of per-step records + postmortem bundles.

The obs event stream answers *where the time went*; the flight recorder
answers *what training looked like right before it died*. It keeps the last
``capacity`` steps' structured records (loss, grad-norm, per-family update
ratios, reward/advantage stats, sampled-lane entropy, comms/compaction/health
probes, anomaly verdicts) in a fixed-size ring, and on any trip — sentinel
divergence, rollback, chaos fault, SIGTERM/peer-loss drain, atexit crash —
dumps the ring plus its context as a durable **postmortem bundle** that
``cli.obs_report --postmortem`` renders as a step-by-step timeline.

Hot-path contract:

- :meth:`FlightRecorder.record` buffers the step's scalars as they are:
  0-dim tensors (on the card) stay tensors, no ``float()``, no ``.item()``,
  one host ``perf_counter`` read; the step loops stay zero-sync.
- :meth:`FlightRecorder.flush` makes ONE readback for everything buffered
  (``torch.stack(...).cpu()`` over the buffered tensors of a device) on
  the existing ``log_every_steps`` / epoch-end cadence, finalizes the ring
  records, and feeds the anomaly detector (:mod:`obs.anomaly`).
  ``readbacks`` counts the flushes that read tensors back.
- Everything is a no-op when no recorder is configured (``train.obs`` off or
  ``train.recorder_steps == 0``).

Bundle layout (all files manifest-checksummed via :mod:`resilience.durable`,
written tmp-dir-then-rename like a checkpoint)::

    postmortem_<n>_<reason>/
      ring.jsonl         one JSON line per ring record, oldest first
      registry.json      full metrics-registry snapshot at dump time
      events_tail.jsonl  last lines of the live obs event stream
      config.json        the run's resolved config (as configured)
      meta.json          reason, trip fields, ring coverage, schema version
      manifest.json      sha256 + size per file (durable.write_manifest)

torch and :mod:`resilience.durable` are imported lazily (flush/dump time).
The bundle schema is the JAX package's, so each package's
``load_postmortem`` reads the other's bundles.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Callable

from cst_captioning_tpu_torch.obs import metrics as _metrics
# name imports, not `obs import span`: the obs package re-exports the span()
# context-manager FUNCTION under that name, shadowing the submodule
from cst_captioning_tpu_torch.obs.span import (
    active as _span_active,
    event as _span_event,
    wall_time as _wall_time,
)

# registry metrics attached to every flush batch as the records' ``probe``
# field: the host-side run state a postmortem wants next to the step scalars
_PROBE_GAUGES = (
    "comm.bytes_on_wire", "comm.buckets", "health.peers_alive",
    "health.peer_age_max_s", "serving.slo.burn_rate.60s",
    "serving.param_version",
    "serving.pages.in_use", "serving.pages.free",
    "serving.pages.table_rows",
    "rl.actor.occupancy", "rl.learner.occupancy",
)
_PROBE_COUNTERS = (
    "rl.decode.compaction.lanes_stepped",
    "rl.decode.compaction.lanes_skipped",
    "rl.staleness.dropped", "rl.actor.preempted",
    "resilience.nan_skip", "resilience.rollback", "resilience.chaos_fault",
    "health.peer_lost",
    "resilience.regrow.attempts", "resilience.regrow.admitted",
    "resilience.regrow.refused",
    "serving.gather_bytes_avoided",
)

_EVENTS_TAIL_LINES = 200

# monotonic<->wall anchor pairs kept per recorder: one at start plus one per
# flush, capped so a long run's meta.json stays small (the last slot keeps
# sliding forward, so the newest anchor always brackets the newest records)
_MAX_ANCHORS = 256

# bundle meta schema history:
#   1 — reason/run/capacity/steps/dumped_ts
#   2 — + proc/world/host identity and ``anchors`` (the JAX package's fleet
#       merge puts N rings on one corrected timeline with them)
_META_SCHEMA = 2


def _read_back(dicts: list[dict]) -> tuple[list[dict], bool]:
    """-> (the dicts with every tensor value as a host float, whether any
    tensor was read). The tensors of each device come back in one
    ``torch.stack(...).cpu()``; any other value passes through."""
    import torch  # lazy: keep the module importable without torch

    by_dev: dict = {}
    for i, d in enumerate(dicts):
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                by_dev.setdefault(v.device, []).append((i, k, v))
    out = [dict(d) for d in dicts]
    for items in by_dev.values():
        vals = torch.stack([v.detach().reshape(()).double()
                            for _, _, v in items]).cpu().tolist()
        for (i, k, _), x in zip(items, vals):
            out[i][k] = x
    return out, bool(by_dev)


def _sanitize(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:64] or "unknown"


class FlightRecorder:
    """Ring buffer of per-step records + the postmortem dump machinery."""

    def __init__(self, capacity: int, out_dir: str, run: str = "run",
                 detector=None, config: dict | None = None,
                 max_dumps: int = 4,
                 probe: Callable[[], dict] | None = None,
                 proc: int = 0, world: int = 1, host: str = ""):
        if capacity < 1:
            raise ValueError(f"recorder capacity {capacity} must be >= 1")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.run = run
        self.detector = detector
        self.config = config or {}
        self.max_dumps = max_dumps
        self.probe = probe
        # host identity: which process/host this ring belongs to, so the
        # fleet merge can name hosts instead of bundle paths
        self.proc = int(proc)
        self.world = max(int(world), 1)
        self.host = host or socket.gethostname()
        self.ring: deque[dict] = deque(maxlen=capacity)
        self._buf: list[tuple[int, str, Any, float]] = []
        self._lock = threading.Lock()
        self._dumps = 0
        self._last_t: float | None = None
        self._closed = False
        self.readbacks = 0   # flushes that read tensors back
        # perf_counter -> wall-clock mapping fixed at configure time: records
        # get absolute timestamps without a wall-clock read per step
        self._pc0 = time.perf_counter()
        self._wall0 = _wall_time()
        # anchors pair the monotonic clock with the wall clock at start and
        # at each flush; the fleet merge maps ring ``ts`` (derived from the
        # start anchor alone) through the freshest bracket, so NTP steps or
        # wall-clock drift during the run don't corrupt cross-host alignment
        self._anchors: list[tuple[float, float]] = [(self._pc0, self._wall0)]
        self._atexit = self._crash_dump
        atexit.register(self._atexit)

    # ---- hot path -----------------------------------------------------------

    def record(self, step: int, phase: str, scalars: dict) -> None:
        """Buffer one step's scalars (0-dim tensors and/or host floats) —
        zero-sync: values are not read here, only held until :meth:`flush`."""
        t = time.perf_counter()
        with self._lock:
            self._buf.append((step, phase, scalars, t))

    def flush(self) -> None:
        """ONE host readback for every buffered step, then ring + anomaly
        finalization. Safe from any thread; no-op when nothing is buffered."""
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        values, read = _read_back([scalars for _, _, scalars, _ in buf])
        self.readbacks += read
        probe = self._probe()
        anchor = (time.perf_counter(), _wall_time())
        with self._lock:
            if len(self._anchors) < _MAX_ANCHORS:
                self._anchors.append(anchor)
            else:
                self._anchors[-1] = anchor
            for (step, phase, _, t), vals in zip(buf, values):
                rec: dict[str, Any] = {
                    "step": int(step),
                    "phase": phase,
                    "ts": self._wall0 + (t - self._pc0),
                }
                for k, v in vals.items():
                    rec[k] = float(v)
                if probe:
                    rec["probe"] = probe
                rec["anomalies"] = self._judge(rec, t)
                self.ring.append(rec)

    def _judge(self, rec: dict, t: float) -> list[str]:
        last_t, self._last_t = self._last_t, t
        det = self.detector
        if det is None:
            return []
        step, phase = rec["step"], rec["phase"]
        out: list[str] = []
        loss = rec.get("loss", rec.get("rl_loss"))
        if loss is not None:
            out += det.observe("loss", loss, step=step, phase=phase)
        if "grad_norm" in rec:
            out += det.observe("grad_norm", rec["grad_norm"], step=step,
                               phase=phase)
        if "reward_mean" in rec:
            out += det.observe("reward", rec["reward_mean"], step=step,
                               phase=phase)
        if last_t is not None:
            gap = t - last_t
            out += det.observe("step_time", gap, step=step, phase=phase)
            out += det.observe_gap(gap, step=step, phase=phase)
        # dedupe, order-preserving: loss AND grad_norm going non-finite on
        # the same step is one verdict, not two
        return list(dict.fromkeys(out))

    def _probe(self) -> dict:
        if self.probe is not None:
            try:
                return dict(self.probe())
            except Exception:
                return {}
        out: dict[str, float] = {}
        snap = _metrics.snapshot()
        for name in _PROBE_GAUGES:
            v = snap["gauges"].get(name)
            if v is not None:
                out[name] = float(v)
        for name in _PROBE_COUNTERS:
            v = snap["counters"].get(name)
            if v is not None:
                out[name] = float(v)
        return out

    # ---- postmortem bundles -------------------------------------------------

    def postmortem(self, reason: str, *,
                   registry_extra: dict | None = None,
                   **fields: Any) -> str | None:
        """Flush, then dump the ring + context as a durable bundle.

        ``registry_extra`` merges extra top-level blocks into the bundle's
        ``registry.json`` (the serving drain rides its SLO snapshot along
        this way). Returns the bundle directory, or ``None`` when the
        per-process dump budget (``max_dumps``) is spent — a run stuck in a
        divergence loop must not fill the disk with identical bundles."""
        flush_error = ""
        try:
            self.flush()
        except Exception as e:
            # a dying process still gets the already-flushed ring; the
            # failure itself is evidence and rides along in meta.json
            flush_error = f"{type(e).__name__}: {e}"
        with self._lock:
            if self._dumps >= self.max_dumps:
                self._budget_gauge()
                return None
            self._dumps += 1
            n = self._dumps
            ring = list(self.ring)
            anchors = list(self._anchors)
        self._budget_gauge()
        # lazy: only dump paths (never import time) pay the import
        from cst_captioning_tpu_torch.resilience import durable

        name = f"postmortem_{n:02d}_{_sanitize(reason)}"
        final = os.path.join(self.out_dir, name)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = {
            "schema": _META_SCHEMA,
            "reason": reason,
            "run": self.run,
            "proc": self.proc,
            "world": self.world,
            "host": self.host,
            "capacity": self.ring.maxlen,
            "steps": [r["step"] for r in ring],
            "anchors": [[pc, wall] for pc, wall in anchors],
            "dumped_ts": _wall_time(),
            **fields,
        }
        if flush_error:
            meta["flush_error"] = flush_error
        registry = _metrics.snapshot()
        if registry_extra:
            registry = {**registry, **registry_extra}
        blobs = {
            "ring.jsonl": "".join(
                json.dumps(r, default=float) + "\n" for r in ring
            ).encode(),
            "registry.json": json.dumps(
                registry, default=float, indent=2
            ).encode(),
            "events_tail.jsonl": self._events_tail(),
            "config.json": json.dumps(
                self.config, default=str, indent=2
            ).encode(),
            "meta.json": json.dumps(meta, default=float, indent=2).encode(),
        }
        for fname, blob in blobs.items():
            durable.write_bytes_durable(os.path.join(tmp, fname), blob)
        durable.write_manifest(tmp, blobs)
        durable.fsync_dir(tmp)
        if os.path.exists(final):  # stale bundle from a prior run: keep ours
            final = final + "_" + str(int(meta["dumped_ts"]))
        os.replace(tmp, final)
        durable.fsync_dir(self.out_dir)
        _span_event("postmortem", reason=reason, bundle=final,
                    steps=len(ring))
        return final

    def _budget_gauge(self) -> None:
        """Export the remaining dump budget — an exhausted budget means later
        trips leave no bundle, which a dashboard should show *before* the
        postmortem someone goes looking for turns out not to exist. Only the
        process-global recorder owns the gauge; ephemeral recorders (serving
        drains without obs configured) must not clobber it."""
        if _FLIGHT is self:
            left = max(self.max_dumps - self._dumps, 0)
            _metrics.gauge("obs.recorder.dump_budget").set(float(left))

    def _events_tail(self) -> bytes:
        """Last lines of the live obs event stream (line-buffered on disk, so
        this is current up to the latest emit)."""
        rec = _span_active()
        if rec is None:
            return b""
        path = os.path.join(rec.out_dir, "events.jsonl")
        try:
            with open(path, "rb") as f:
                lines = f.readlines()
        except OSError:
            return b""
        return b"".join(lines[-_EVENTS_TAIL_LINES:])

    # ---- lifecycle ----------------------------------------------------------

    def _crash_dump(self) -> None:
        """atexit hook: a process that never reached :meth:`close` died with
        work in flight — dump what the ring holds."""
        try:
            self.postmortem("atexit_crash")
        except Exception as e:
            # interpreter teardown: the event stream may already be closed,
            # stderr is the only sink left standing
            sys.stderr.write(f"flight-recorder: atexit dump failed: {e}\n")

    def close(self) -> None:
        """Clean shutdown: final flush, no dump, atexit hook disarmed."""
        if self._closed:
            return
        self._closed = True
        if self._atexit is not None:
            atexit.unregister(self._atexit)
            self._atexit = None
        try:
            self.flush()
        except Exception as e:
            sys.stderr.write(f"flight-recorder: final flush failed: {e}\n")


# ---- process-global wiring (mirrors obs.span's configure/active) ------------

_FLIGHT: FlightRecorder | None = None


def configure(capacity: int, out_dir: str, run: str = "run", detector=None,
              config: dict | None = None, max_dumps: int = 4,
              probe: Callable[[], dict] | None = None,
              proc: int = 0, world: int = 1,
              host: str = "") -> FlightRecorder:
    """Install the process-global flight recorder (closing any previous)."""
    global _FLIGHT
    if _FLIGHT is not None:
        _FLIGHT.close()
    _FLIGHT = FlightRecorder(capacity, out_dir, run=run, detector=detector,
                             config=config, max_dumps=max_dumps, probe=probe,
                             proc=proc, world=world, host=host)
    _FLIGHT._budget_gauge()
    return _FLIGHT


def shutdown() -> None:
    """Cleanly close and uninstall the recorder (no crash dump)."""
    global _FLIGHT
    if _FLIGHT is not None:
        _FLIGHT.close()
        _FLIGHT = None


def active() -> FlightRecorder | None:
    return _FLIGHT


def record(step: int, phase: str, scalars: dict) -> None:
    """Buffer one step's scalars on the global recorder (no-op when off)."""
    fr = _FLIGHT
    if fr is not None:
        fr.record(step, phase, scalars)


def flush() -> None:
    fr = _FLIGHT
    if fr is not None:
        fr.flush()


def postmortem(reason: str, *, registry_extra: dict | None = None,
               **fields: Any) -> str | None:
    fr = _FLIGHT
    if fr is not None:
        return fr.postmortem(reason, registry_extra=registry_extra, **fields)
    return None


def note_fault(point: str, kind: str, visit: int, **fields: Any) -> None:
    """Chaos-harness hook (``resilience/chaos.py`` calls it as a fault
    fires): an injected fault is a trip — capture the ring as it was when
    the fault fired, before its consequences land. Extra ``fields`` (e.g.
    the victim ``host`` of a ``partial_preempt``) ride into the bundle's
    meta so the fleet merge can name the victim.

    A fault can fire on the prefetch worker or the reward thread, whose
    current stream is not the step loop's: the device is synchronized
    first, so the readback of the buffered tensors waits for the steps
    that wrote them."""
    fr = _FLIGHT
    if fr is not None:
        if threading.current_thread() is not threading.main_thread():
            import torch  # lazy, as in _read_back

            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        fr.postmortem(f"chaos_{kind}", point=point, visit=visit, **fields)
