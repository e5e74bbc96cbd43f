"""Turn a run's obs event stream into a phase-breakdown + resilience report.

Pure stdlib over ``<run_dir>/events.jsonl`` (the :mod:`obs.span` stream) —
no torch import, so ``python -m cst_captioning_tpu_torch.cli.obs_report``
runs anywhere in milliseconds. The JAX package's module, copied: a stream
from either package renders the same report in both.

Accounting model: every finished span carries its full duration AND its
*self* time (duration minus time spent in child spans on the same thread).
Grouping self-time by span name partitions the instrumented wall clock
exactly — nested spans never double count — so the phase table's totals sum
to the span-covered fraction of the run, and ``coverage`` says how much of
the measured wall clock the instrumentation explains. p50/p95/max are over
full per-span durations (the latency view); totals/percentages are over
self time (the where-did-the-time-go view). Only spans from the run's
foreground thread (the one that configured the recorder) enter the phase
table: background threads (the prefetch worker) and virtual-track windows
(the profiler trace) run CONCURRENTLY with it — they're reported in a
separate overlap section, never summed against wall clock.

The resilience summary reads the LAST metrics snapshot in the stream —
counters are cumulative, so the newest snapshot is the run total even if
the run died between cadenced snapshots. The same snapshot feeds two more
sections:

- the phase table's **mfu** column: ``flops.<phase>`` counters (analytic
  matmul FLOPs the trainer/SCST loop accumulate per step, obs/flops.py)
  over the RUN's wall clock and the chip's assumed peak
  (``device.peak_flops`` gauge) — each row is that phase's contribution to
  run MFU, so the rows SUM to the run's overall analytic MFU. Wall clock,
  not span self-time, because device programs are dispatched async: a
  span's wall time measures the host's dispatch window, not the device
  occupancy, and dividing by it would fabricate impossible MFUs.
- the **decode early-exit** section: the ``rl.decode.depth`` histogram
  (scan steps the EOS early-exit loop actually ran per batch, observed
  host-side from the decoded tokens) against the ``rl.decode.budget``
  gauge (the T step budget) — what ``scan_until_finished`` saves per
  epoch.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Iterable

EVENTS_FILE = "events.jsonl"

# per-process sub-streams of a multi-host run: process 0 writes the run dir
# itself, processes k>0 write proc<k>/ underneath it (Trainer obs wiring)
_PROC_DIR_RE = re.compile(r"^proc(\d+)$")

# canonical phase order for the table; unknown names sort after, by total
_PHASE_ORDER = (
    "setup", "xe.epoch", "xe.step", "rl.epoch", "rl.decode", "rl.reward",
    "rl.update", "rl.actor.decode", "rl.actor.broadcast", "rl.learner.step",
    "eval", "eval.pipeline.fill", "eval.pipeline.drain",
    "eval.score", "serving.admit", "serving.encode",
    "serving.stride", "serving.detok", "ckpt", "ckpt.save", "ckpt.restore",
    "dcn.collective", "degraded_rendezvous", "prefetch.stage",
    "profile.window",
)

# per-request serving phases surfaced as their own report section (the
# engine records one histogram observation per request per phase)
_SERVING_PHASES = ("queue_wait", "encode", "decode", "detok")


def load_events(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, EVENTS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {EVENTS_FILE} under {run_dir!r} — was the run started with "
            "train.obs enabled (or --obs)?"
        )
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn final line of a killed run
    return out


def _hist_quantile(snap: dict, q: float) -> float:
    """Bucket-interpolated quantile over a Histogram SNAPSHOT dict
    (mirrors obs.metrics.Histogram.quantile, which the report cannot call —
    it only sees the serialized {buckets, counts, sum, count, max})."""
    bounds, counts = snap.get("buckets", []), snap.get("counts", [])
    total, vmax = snap.get("count", 0), snap.get("max", 0.0)
    if not total:
        return 0.0
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= rank and c > 0:
            if i >= len(bounds):
                return vmax
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - seen) / c
            return min(lo + (hi - lo) * frac, vmax if vmax else hi)
        seen += c
    return vmax


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Exact nearest-rank-interpolated percentile over raw durations."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def build_report(events: Iterable[dict]) -> dict[str, Any]:
    """Aggregate an event stream into the report structure (JSON-ready)."""
    events = list(events)
    spans: dict[str, dict] = {}
    overlap: dict[str, dict] = {}
    t_first = t_last = None
    t_start = t_end = None
    run = ""
    main_thread: str | None = None
    last_metrics: dict | None = None
    profiler_windows = 0

    for ev in events:
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            t_first = ts if t_first is None else min(t_first, ts)
            t_last = ts if t_last is None else max(t_last, ts)
        kind = ev.get("event")
        if kind == "run_start":
            t_start = ts
            run = ev.get("run", run)
            main_thread = ev.get("thread", main_thread)
        elif kind == "run_end":
            t_end = ts
        elif kind == "metrics":
            last_metrics = ev
        elif kind == "profiler_trace_written":
            profiler_windows += 1
        elif kind == "span":
            name = str(ev.get("name", "?"))
            foreground = not ev.get("track") and (
                main_thread is None or ev.get("thread", main_thread) == main_thread
            )
            agg = (spans if foreground else overlap).setdefault(
                name, {"count": 0, "total": 0.0, "self_total": 0.0,
                       "durs": []},
            )
            dur = float(ev.get("dur", 0.0))
            agg["count"] += 1
            agg["total"] += dur
            agg["self_total"] += float(ev.get("self_dur", dur))
            agg["durs"].append(dur)

    wall = 0.0
    if t_start is not None and t_end is not None:
        wall = max(t_end - t_start, 0.0)
    elif t_first is not None and t_last is not None:
        wall = max(t_last - t_first, 0.0)

    order = {name: i for i, name in enumerate(_PHASE_ORDER)}
    counters = (last_metrics or {}).get("counters", {})
    gauges = (last_metrics or {}).get("gauges", {})
    histograms = (last_metrics or {}).get("histograms", {})
    peak = float(gauges.get("device.peak_flops", 0.0))

    def rows(groups: dict[str, dict]) -> list[dict]:
        out = []
        for name, agg in groups.items():
            durs = sorted(agg["durs"])
            flops = float(counters.get(f"flops.{name}", 0.0))
            # which FLOPs source the mfu cell reflects: the trainer/SCST/
            # serving loops publish flops.backend.<phase> = 1.0 when the
            # counter accumulates the COMPILED program's XLA cost, 0.0 for
            # the analytic matmul model (obs/flops.py); absent = the phase
            # predates the probe or never counted FLOPs
            backend = gauges.get(f"flops.backend.{name}")
            out.append({
                "phase": name,
                "count": agg["count"],
                "total_s": agg["total"],
                "self_s": agg["self_total"],
                "pct_wall": (
                    100.0 * agg["self_total"] / wall if wall > 0 else 0.0
                ),
                # this phase's contribution to run MFU: analytic FLOPs over
                # run wall x chip peak (module docstring — span wall would
                # measure the async dispatch window, not device occupancy)
                "mfu": (
                    flops / wall / peak if flops and wall > 0 and peak > 0
                    else None
                ),
                "flops_backend": (
                    None if backend is None
                    else ("compiled" if backend else "analytic")
                ),
                "p50_s": _percentile(durs, 0.50),
                "p95_s": _percentile(durs, 0.95),
                "max_s": durs[-1] if durs else 0.0,
            })
        out.sort(key=lambda p: (order.get(p["phase"], len(order)),
                                -p["self_s"]))
        return out

    phases = rows(spans)
    overlap_rows = rows(overlap)
    covered = sum(p["self_s"] for p in phases)

    depth = histograms.get("rl.decode.depth")
    decode = None
    if depth and depth.get("count"):
        budget = float(gauges.get("rl.decode.budget", 0.0))
        mean = depth["sum"] / depth["count"]
        stepped = float(counters.get("rl.decode.compaction.lanes_stepped", 0))
        skipped = float(counters.get("rl.decode.compaction.lanes_skipped", 0))
        decode = {
            "batches": depth["count"],
            "depth_mean": mean,
            "depth_p50": _hist_quantile(depth, 0.50),
            "depth_p95": _hist_quantile(depth, 0.95),
            "depth_max": depth["max"],
            "budget": budget,
            # share of the T-step budget the early exit skipped
            "saved_frac": (1.0 - mean / budget) if budget > 0 else 0.0,
            # finished-lane compaction ledger (rl.decode.compaction.*
            # counter pair, SCSTTrainer._observe_decode): lane-column steps
            # the driving loop computed vs compacted away
            "lanes_stepped": stepped,
            "lanes_skipped": skipped,
            "compaction_saved_frac": (
                skipped / (stepped + skipped) if stepped + skipped > 0
                else 0.0
            ),
        }

    # serving section (serving/engine.py): request funnel counters + the
    # per-request phase histograms (queue-wait / encode / decode / detok)
    # and the paged-bank gauges. None when the run never served.
    serving = None
    lat = histograms.get("serving.latency_seconds")
    if counters.get("serving.requests_submitted") or (
        lat and lat.get("count")
    ):
        phases_out = {}
        for name in _SERVING_PHASES:
            h = histograms.get(f"serving.{name}_seconds")
            if h and h.get("count"):
                phases_out[name] = {
                    "count": h["count"],
                    "p50_s": _hist_quantile(h, 0.50),
                    "p95_s": _hist_quantile(h, 0.95),
                    "max_s": h.get("max", 0.0),
                }
        serving = {
            "submitted": counters.get("serving.requests_submitted", 0),
            "admitted": counters.get("serving.requests_admitted", 0),
            "completed": counters.get("serving.requests_completed", 0),
            "strides": counters.get("serving.strides", 0),
            "drains": counters.get("serving.drains", 0),
            "admission_blocked_pages": counters.get(
                "serving.admission_blocked_pages", 0
            ),
            "latency_p50_s": _hist_quantile(lat, 0.50) if lat else 0.0,
            "latency_p95_s": _hist_quantile(lat, 0.95) if lat else 0.0,
            "latency_max_s": (lat or {}).get("max", 0.0),
            "phases": phases_out,
            "pages_in_use": gauges.get("serving.pages_in_use"),
            "slots_in_use": gauges.get("serving.slots_in_use"),
            "queue_depth": gauges.get("serving.queue_depth"),
            # paged in-kernel attention (ops/decode_pallas
            # .fused_decode_stride_paged): device-resident page-table
            # occupancy + encode-ahead staging depth + the HBM bytes the
            # killed dense-bank gather would have moved
            "pages": {
                "in_use": gauges.get("serving.pages.in_use"),
                "free": gauges.get("serving.pages.free"),
                "table_rows": gauges.get("serving.pages.table_rows"),
            },
            "staged": counters.get("serving.requests_staged", 0),
            "gather_bytes_avoided": counters.get(
                "serving.gather_bytes_avoided", 0
            ),
            # drain-free hot param swap (serving/engine.publish_params):
            # the active learner-param version plus applied/refused swaps
            "param_version": gauges.get("serving.param_version"),
            "param_swaps": counters.get("serving.param_swaps", 0),
            "param_swaps_refused": counters.get(
                "serving.param_swaps_refused", 0
            ),
        }
        # SLO burn-rate monitor (serving/engine.SloMonitor): rolling-window
        # attainment/burn gauges + breach/alert counters, keyed by window
        slo_windows = sorted(
            int(m.group(1)) for m in (
                re.match(r"serving\.slo\.attainment\.(\d+)s$", k)
                for k in gauges
            ) if m
        )
        if slo_windows:
            serving["slo"] = {
                "target_s": gauges.get("serving.slo.target_s"),
                "windows": {
                    w: {
                        "attainment": gauges.get(
                            f"serving.slo.attainment.{w}s"
                        ),
                        "burn_rate": gauges.get(
                            f"serving.slo.burn_rate.{w}s"
                        ),
                    }
                    for w in slo_windows
                },
                "breaches": counters.get("serving.slo.breaches", 0),
                "alerts": counters.get("serving.slo.alerts", 0),
            }

    # eval overlap ledger (eval/evaluator.py _evaluate_pipelined): per-batch
    # decode-stage and per-shard score-stage histograms plus the stage-total
    # gauges from the two-stage decode/score pipeline. None when the run
    # never ran a pipelined eval (serial evaluator, multi-host, or no eval).
    eval_sec = None
    edec = histograms.get("eval.decode_seconds")
    esc = histograms.get("eval.score_seconds")
    if (edec and edec.get("count")) or (esc and esc.get("count")):
        eval_sec = {
            "batches": counters.get("eval.batches", 0),
            "captions": counters.get("eval.captions", 0),
            "decode_total_s": gauges.get("eval.decode_total_s", 0.0),
            "score_total_s": gauges.get("eval.score_total_s", 0.0),
            "wall_s": gauges.get("eval.wall_s", 0.0),
            "decode_p50_s": _hist_quantile(edec, 0.50) if edec else 0.0,
            "decode_p95_s": _hist_quantile(edec, 0.95) if edec else 0.0,
            "score_p50_s": _hist_quantile(esc, 0.50) if esc else 0.0,
            "score_p95_s": _hist_quantile(esc, 0.95) if esc else 0.0,
            "overlap_fraction": gauges.get("eval.overlap_fraction", 0.0),
            "overlap_efficiency": gauges.get("eval.overlap_efficiency", 0.0),
            "fill_s": gauges.get("eval.pipeline.fill_s", 0.0),
            "drain_s": gauges.get("eval.pipeline.drain_s", 0.0),
        }

    # decoupled actor/learner RL (rl/async_scst.py): throughput counters,
    # host-observed occupancy gauges, and the staleness-in-updates
    # histogram. None when the run never used train.rl_topology="decoupled".
    rl_async = None
    stale = histograms.get("rl.staleness")
    if counters.get("rl.actor.batches") or counters.get("rl.learner.steps") \
            or (stale and stale.get("count")):
        rl_async = {
            "actor_batches": counters.get("rl.actor.batches", 0),
            "learner_steps": counters.get("rl.learner.steps", 0),
            "dropped_stale": counters.get("rl.staleness.dropped", 0),
            "actor_preemptions": counters.get("rl.actor.preempted", 0),
            "actor_occupancy": gauges.get("rl.actor.occupancy"),
            "learner_occupancy": gauges.get("rl.learner.occupancy"),
            "staleness_mean": (
                stale["sum"] / stale["count"]
                if stale and stale.get("count") else 0.0
            ),
            "staleness_p95": (
                _hist_quantile(stale, 0.95)
                if stale and stale.get("count") else 0.0
            ),
            "staleness_max": (stale or {}).get("max", 0.0),
        }

    resilience = {
        "nan_skips": counters.get("resilience.nan_skip", 0),
        "divergences": sum(
            v for k, v in counters.items()
            if k.startswith("resilience.divergence.")
        ),
        "rollbacks": counters.get("resilience.rollback", 0),
        "retry_attempts": counters.get("resilience.retry.attempt", 0),
        "retry_give_ups": counters.get("resilience.retry.give_up", 0),
        "ckpt_corrupt_fallbacks": counters.get("resilience.ckpt_corrupt", 0),
        "ckpt_enospc": counters.get("resilience.ckpt_enospc", 0),
        "prefetch_stalls": counters.get("resilience.prefetch_stall", 0),
        "h2d_retries": counters.get("resilience.h2d_retry", 0),
        "peer_loss_drains": counters.get("resilience.peer_loss_drain", 0),
        "degraded_continuations": counters.get(
            "resilience.degraded_continuation", 0
        ),
        "chaos_faults": counters.get("resilience.chaos_fault", 0),
        "chaos_faults_by_kind": {
            k.rsplit(".", 1)[1]: v
            for k, v in counters.items()
            if k.startswith("resilience.chaos_fault.")
        },
    }

    # elastic-health summary (resilience/health.py): heartbeat gauges + the
    # DCN-stall probe around cross-host collectives. None when the run never
    # produced a health signal (monitor off, single-host, no collectives).
    dcn = histograms.get("dcn.collective_seconds")
    health = None
    if any((
        counters.get("health.heartbeats"), counters.get("health.dcn_stall"),
        counters.get("health.peer_lost"), dcn and dcn.get("count"),
        "health.peers_alive" in gauges,
    )):
        health = {
            "heartbeats": counters.get("health.heartbeats", 0),
            "peers_alive": gauges.get("health.peers_alive"),
            "peer_age_max_s": gauges.get("health.peer_age_max_s"),
            "peer_losses": counters.get("health.peer_lost", 0),
            "dcn_stalls": counters.get("health.dcn_stall", 0),
            "collectives": dcn.get("count", 0) if dcn else 0,
            "collective_p95_s": (
                _hist_quantile(dcn, 0.95) if dcn and dcn.get("count") else 0.0
            ),
        }

    return {
        "run": run,
        "wall_s": wall,
        "covered_s": covered,
        "coverage": covered / wall if wall > 0 else 0.0,
        "complete": t_end is not None,
        "phases": phases,
        "overlap": overlap_rows,
        "decode": decode,
        "serving": serving,
        "eval": eval_sec,
        "rl_async": rl_async,
        "resilience": resilience,
        "health": health,
        "compile": {
            "count": counters.get("jit.compiles", 0),
            "seconds": counters.get("jit.compile_seconds", 0.0),
        },
        "profiler_windows": profiler_windows,
        # absolute run window (wall-clock): feeds the cross-process skew
        # attribution when per-proc streams are merged
        "t_start": t_start if t_start is not None else t_first,
        "t_end": t_end if t_end is not None else t_last,
        "events": len(events),
    }


def _fmt_s(v: float) -> str:
    return f"{v:8.3f}"


def render_report(report: dict[str, Any]) -> str:
    """Fixed-width human rendering of :func:`build_report`'s output."""
    lines: list[str] = []
    run = report["run"] or "(unnamed)"
    tail = "" if report["complete"] else "  [run did not close cleanly]"
    lines.append(f"run: {run}   wall clock: {report['wall_s']:.3f}s   "
                 f"events: {report['events']}{tail}")
    comp = report["compile"]
    if comp["count"] or comp["seconds"]:
        lines.append(
            f"jit: {int(comp['count'])} backend compile(s), "
            f"{comp['seconds']:.3f}s total compile time"
        )
    if report["profiler_windows"]:
        lines.append(f"profiler: {report['profiler_windows']} trace "
                     "window(s) captured")
    lines.append("")
    hdr = (f"{'phase':<16} {'count':>6} {'total_s':>8} {'self_s':>8} "
           f"{'%wall':>6} {'mfu':>7} {'p50_s':>8} {'p95_s':>8} {'max_s':>8}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    mfu_total = 0.0
    backends_seen = set()
    for p in report["phases"]:
        mfu = p.get("mfu")
        mfu_total += mfu or 0.0
        backend = p.get("flops_backend")
        if mfu is not None:
            # single-char FLOPs-source tag on the mfu cell: c = compiled
            # XLA cost, a = analytic model (legend below the table)
            mark = {"compiled": "c", "analytic": "a"}.get(backend, " ")
            backends_seen.add(mark.strip() or None)
            mfu_col = f"{mfu:6.4f}{mark}"
        else:
            mfu_col = " " * 7
        lines.append(
            f"{p['phase']:<16} {p['count']:>6} {_fmt_s(p['total_s'])} "
            f"{_fmt_s(p['self_s'])} {p['pct_wall']:>6.1f} {mfu_col} "
            f"{_fmt_s(p['p50_s'])} {_fmt_s(p['p95_s'])} {_fmt_s(p['max_s'])}"
        )
    lines.append("-" * len(hdr))
    lines.append(
        f"{'covered':<16} {'':>6} {'':>8} {_fmt_s(report['covered_s'])} "
        f"{100.0 * report['coverage']:>6.1f}"
        + (f" {mfu_total:7.4f}" if mfu_total else "")
    )
    if backends_seen - {None}:
        lines.append(
            "mfu flops source: c = compiled program (XLA cost analysis), "
            "a = analytic matmul model"
        )
    if report["overlap"]:
        lines.append("")
        lines.append("overlapped work (background threads / virtual tracks,"
                     " not part of the wall-clock sum):")
        for p in report["overlap"]:
            lines.append(
                f"{p['phase']:<16} {p['count']:>6} {_fmt_s(p['total_s'])} "
                f"{_fmt_s(p['self_s'])} {'':>6} "
                f"{_fmt_s(p['p50_s'])} {_fmt_s(p['p95_s'])} "
                f"{_fmt_s(p['max_s'])}"
            )
    d = report.get("decode")
    if d:
        lines.append("")
        lines.append(
            f"decode early-exit: {int(d['batches'])} batch(es), depth "
            f"p50/p95/max {d['depth_p50']:.1f}/{d['depth_p95']:.1f}/"
            f"{d['depth_max']:.0f} of budget {d['budget']:.0f} steps "
            f"(mean {d['depth_mean']:.1f} — early exit skips "
            f"{100.0 * d['saved_frac']:.1f}% of the scan budget)"
        )
        if d["lanes_stepped"] or d["lanes_skipped"]:
            lines.append(
                f"decode compaction: {int(d['lanes_stepped'])} lane-steps "
                f"computed, {int(d['lanes_skipped'])} skipped "
                f"({100.0 * d['compaction_saved_frac']:.1f}% of lane-steps "
                "compacted away)"
            )
    sv = report.get("serving")
    if sv:
        lines.append("")
        lines.append(
            f"serving: {int(sv['submitted'])} submitted, "
            f"{int(sv['admitted'])} admitted, {int(sv['completed'])} "
            f"completed over {int(sv['strides'])} stride(s); latency "
            f"p50/p95/max {sv['latency_p50_s']:.3f}/"
            f"{sv['latency_p95_s']:.3f}/{sv['latency_max_s']:.3f}s"
        )
        for name in _SERVING_PHASES:
            p = sv["phases"].get(name)
            if p:
                lines.append(
                    f"  {name:<12} {int(p['count']):>6} req(s)  p50 "
                    f"{p['p50_s']:.4f}s  p95 {p['p95_s']:.4f}s  max "
                    f"{p['max_s']:.4f}s"
                )
        slo = sv.get("slo")
        if slo:
            target = slo.get("target_s")
            win_bits = "   ".join(
                f"{w}s: {100.0 * (v['attainment'] or 0.0):.1f}% "
                f"(burn {v['burn_rate'] or 0.0:.1f}x)"
                for w, v in sorted(slo["windows"].items())
            )
            lines.append(
                "  slo"
                + (f" (target {target:.3f}s):" if target else ":")
                + f" {win_bits}   breaches: {int(slo['breaches'])}   "
                f"alerts: {int(slo['alerts'])}"
            )
        bits = []
        if sv["drains"]:
            bits.append(f"drains: {int(sv['drains'])}")
        if sv["admission_blocked_pages"]:
            bits.append(
                "page backpressure: "
                f"{int(sv['admission_blocked_pages'])} blocked admission(s)"
            )
        if sv.get("pages_in_use") is not None:
            bits.append(f"pages in use: {int(sv['pages_in_use'])}")
        pg = sv.get("pages") or {}
        if pg.get("in_use") is not None or pg.get("free") is not None:
            bits.append(
                f"page table: {int(pg.get('in_use') or 0)} in use / "
                f"{int(pg.get('free') or 0)} free over "
                f"{int(pg.get('table_rows') or 0)} row(s)"
            )
        if sv.get("staged"):
            bits.append(f"staged admissions: {int(sv['staged'])}")
        if sv.get("gather_bytes_avoided"):
            bits.append(
                "gather bytes avoided: "
                f"{sv['gather_bytes_avoided'] / 2**20:.1f} MiB"
            )
        if sv.get("param_swaps") or sv.get("param_swaps_refused"):
            bits.append(
                f"param swaps: {int(sv['param_swaps'])} applied"
                + (
                    f" / {int(sv['param_swaps_refused'])} refused"
                    if sv.get("param_swaps_refused") else ""
                )
                + (
                    f" (active v{int(sv['param_version'])})"
                    if sv.get("param_version") is not None else ""
                )
            )
        if bits:
            lines.append("  " + "   ".join(bits))
    ev = report.get("eval")
    if ev:
        lines.append("")
        lines.append(
            f"eval pipeline: {int(ev['batches'])} batch(es), "
            f"{int(ev['captions'])} caption(s); stage totals decode "
            f"{ev['decode_total_s']:.3f}s / score {ev['score_total_s']:.3f}s "
            f"over {ev['wall_s']:.3f}s wall"
        )
        lines.append(
            f"  decode p50/p95 {ev['decode_p50_s']:.4f}/"
            f"{ev['decode_p95_s']:.4f}s   score p50/p95 "
            f"{ev['score_p50_s']:.4f}/{ev['score_p95_s']:.4f}s"
        )
        lines.append(
            f"  overlap: {100.0 * ev['overlap_fraction']:.1f}% of scoring "
            f"hidden under decode (efficiency "
            f"{100.0 * ev['overlap_efficiency']:.1f}% of the hideable "
            f"stage)   fill {ev['fill_s']:.3f}s   drain {ev['drain_s']:.3f}s"
        )
    ra = report.get("rl_async")
    if ra:
        lines.append("")
        occ_bits = "   ".join(
            f"{role} occupancy {100.0 * v:.1f}%"
            for role, v in (
                ("actor", ra.get("actor_occupancy")),
                ("learner", ra.get("learner_occupancy")),
            )
            if v is not None
        )
        lines.append(
            f"actor/learner: {int(ra['actor_batches'])} rollout batch(es) "
            f"decoded, {int(ra['learner_steps'])} learner step(s)"
            + (f"   {occ_bits}" if occ_bits else "")
        )
        lines.append(
            f"  staleness (updates): mean {ra['staleness_mean']:.2f}   "
            f"p95 {ra['staleness_p95']:.2f}   max "
            f"{ra['staleness_max']:.0f}   dropped+recounted: "
            f"{int(ra['dropped_stale'])}   actor preemptions: "
            f"{int(ra['actor_preemptions'])}"
        )
    r = report["resilience"]
    lines.append("")
    lines.append("resilience:")
    lines.append(
        f"  nan-skips: {int(r['nan_skips'])}   divergences: "
        f"{int(r['divergences'])}   rollbacks: {int(r['rollbacks'])}"
    )
    lines.append(
        f"  retries: {int(r['retry_attempts'])} attempt(s), "
        f"{int(r['retry_give_ups'])} give-up(s)   ckpt-corrupt fallbacks: "
        f"{int(r['ckpt_corrupt_fallbacks'])}"
    )
    elastic_bits = []
    for key, label in (
        ("peer_loss_drains", "peer-loss drains"),
        ("degraded_continuations", "degraded continuations"),
        ("ckpt_enospc", "ckpt ENOSPC reclaims"),
        ("prefetch_stalls", "prefetch stalls"),
        ("h2d_retries", "h2d retries"),
    ):
        if r.get(key):
            elastic_bits.append(f"{label}: {int(r[key])}")
    if elastic_bits:
        lines.append("  " + "   ".join(elastic_bits))
    by_kind = r["chaos_faults_by_kind"]
    kinds = (
        " (" + ", ".join(f"{k}={int(v)}" for k, v in sorted(by_kind.items()))
        + ")" if by_kind else ""
    )
    lines.append(f"  chaos faults injected: {int(r['chaos_faults'])}{kinds}")
    h = report.get("health")
    if h:
        lines.append("")
        alive = h.get("peers_alive")
        lines.append(
            "health: "
            f"{int(h['heartbeats'])} heartbeat(s)"
            + (f", {int(alive)} peer(s) alive" if alive is not None else "")
            + f", {int(h['peer_losses'])} peer loss(es); "
            f"dcn: {int(h['collectives'])} collective(s), "
            f"p95 {h['collective_p95_s']:.3f}s, "
            f"{int(h['dcn_stalls'])} stall(s)"
        )
    if report.get("hosts"):
        c = report["cluster"]
        lines.append("")
        lines.append(
            f"cluster: {c['processes']} process streams merged — max end "
            f"skew {c['max_end_skew_s']:.3f}s (straggler: proc"
            f"{c['straggler_proc']}); totals: {int(c['chaos_faults'])} chaos "
            f"fault(s), {int(c['dcn_stalls'])} dcn stall(s), "
            f"{int(c['peer_losses'])} peer loss(es)"
        )
        hdr2 = (f"{'proc':>5} {'events':>7} {'wall_s':>8} {'start+':>8} "
                f"{'end+':>8} {'top phase':<16} {'self_s':>8}")
        lines.append(hdr2)
        lines.append("-" * len(hdr2))
        for host in report["hosts"]:
            lines.append(
                f"{host['proc']:>5} {host['events']:>7} "
                f"{_fmt_s(host['wall_s'])} {_fmt_s(host['start_skew_s'])} "
                f"{_fmt_s(host['end_skew_s'])} {host['top_phase']:<16} "
                f"{_fmt_s(host['top_phase_self_s'])}"
            )
    return "\n".join(lines)


def _merge_proc_reports(report: dict[str, Any],
                        procs: list[tuple[int, dict[str, Any]]]) -> None:
    """Fold per-process sub-reports into the primary report: a ``hosts``
    table with per-host skew attribution (who started late, who finished
    last, where that host's time went) and cluster-total resilience/health
    counts. ``procs`` includes process 0 (the primary stream)."""
    ends = [r["t_end"] for _, r in procs if r["t_end"] is not None]
    starts = [r["t_start"] for _, r in procs if r["t_start"] is not None]
    t0 = min(starts) if starts else None
    t_end_min = min(ends) if ends else None
    hosts = []
    for proc, rep in procs:
        top_phase, top_self = "", 0.0
        for p in rep["phases"]:
            if p["self_s"] > top_self:
                top_phase, top_self = p["phase"], p["self_s"]
        hosts.append({
            "proc": proc,
            "events": rep["events"],
            "wall_s": rep["wall_s"],
            "complete": rep["complete"],
            # skew attribution: how late this host started, and how long
            # the earliest-finishing host would have waited on it at the
            # final barrier — the per-host "who is the straggler" answer
            "start_skew_s": (
                rep["t_start"] - t0
                if t0 is not None and rep["t_start"] is not None else 0.0
            ),
            "end_skew_s": (
                rep["t_end"] - t_end_min
                if t_end_min is not None and rep["t_end"] is not None
                else 0.0
            ),
            "top_phase": top_phase,
            "top_phase_self_s": top_self,
            "chaos_faults": rep["resilience"]["chaos_faults"],
            "dcn_stalls": (rep.get("health") or {}).get("dcn_stalls", 0),
        })
    straggler = max(hosts, key=lambda h: h["end_skew_s"])
    report["hosts"] = hosts
    report["cluster"] = {
        "processes": len(hosts),
        "max_end_skew_s": straggler["end_skew_s"],
        "straggler_proc": straggler["proc"],
        # cluster totals: per-process counters are per-host streams, so the
        # cluster view is their SUM (the primary table stays process 0's)
        "chaos_faults": sum(h["chaos_faults"] for h in hosts),
        "dcn_stalls": sum(h["dcn_stalls"] for h in hosts),
        "peer_losses": sum(
            (r.get("health") or {}).get("peer_losses", 0) for _, r in procs
        ),
        "heartbeats": sum(
            (r.get("health") or {}).get("heartbeats", 0) for _, r in procs
        ),
    }


def report_run(run_dir: str) -> dict[str, Any]:
    """Load + aggregate one run dir (the CLI's single entry point).

    Multi-host runs leave one stream per process (process 0 in ``run_dir``
    itself, process k in ``run_dir/proc<k>/``); every stream is merged into
    the ``hosts``/``cluster`` sections with per-host skew attribution."""
    report = build_report(load_events(run_dir))
    procs: list[tuple[int, dict[str, Any]]] = [(0, report)]
    for entry in sorted(os.listdir(run_dir)):
        m = _PROC_DIR_RE.match(entry)
        if m and os.path.exists(os.path.join(run_dir, entry, EVENTS_FILE)):
            procs.append((
                int(m.group(1)),
                build_report(load_events(os.path.join(run_dir, entry))),
            ))
    if len(procs) > 1:
        procs.sort()
        _merge_proc_reports(report, procs)
    return report


# ---- postmortem bundles (obs/recorder.py) -----------------------------------

# the ring-record bookkeeping keys; everything else in a record is a metric
_RING_META_KEYS = ("step", "phase", "ts", "probe", "anomalies")


def _verify_bundle(bundle_dir: str) -> tuple[bool, list[str]]:
    """Inline sha256/size check against the bundle's ``manifest.json``.

    Reimplements ``resilience.durable.verify_manifest`` on purpose: this
    module stays stdlib-only. Returns ``(verified, problems)`` —
    no manifest is reported as unverified, not as an error (the bundle may
    predate the manifest machinery or be mid-write)."""
    mpath = os.path.join(bundle_dir, "manifest.json")
    if not os.path.exists(mpath):
        return False, ["no manifest.json (bundle unverifiable)"]
    try:
        with open(mpath, encoding="utf-8") as f:
            files = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        return False, [f"unreadable manifest: {e}"]
    problems: list[str] = []
    for name, meta in files.items():
        fpath = os.path.join(bundle_dir, name)
        if not os.path.exists(fpath):
            problems.append(f"{name}: missing")
            continue
        size = os.path.getsize(fpath)
        if size != int(meta["size"]):
            problems.append(f"{name}: size {size} != {meta['size']}")
            continue
        h = hashlib.sha256()
        with open(fpath, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != meta["sha256"]:
            problems.append(f"{name}: sha256 mismatch")
    return not problems, problems


def load_postmortem(bundle_dir: str) -> dict[str, Any]:
    """Load a flight-recorder postmortem bundle into a render-ready dict."""
    meta_path = os.path.join(bundle_dir, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"no meta.json under {bundle_dir!r} — is this a "
            "flight-recorder postmortem bundle (obs/recorder.py)?"
        )
    verified, problems = _verify_bundle(bundle_dir)
    with open(meta_path, encoding="utf-8") as f:
        meta = json.load(f)
    ring: list[dict] = []
    ring_path = os.path.join(bundle_dir, "ring.jsonl")
    if os.path.exists(ring_path):
        with open(ring_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        ring.append(json.loads(line))
                    except ValueError:
                        continue  # torn line of a crash-time dump
    registry: dict = {}
    reg_path = os.path.join(bundle_dir, "registry.json")
    if os.path.exists(reg_path):
        try:
            with open(reg_path, encoding="utf-8") as f:
                registry = json.load(f)
        except ValueError:
            pass
    events_tail = 0
    tail_path = os.path.join(bundle_dir, "events_tail.jsonl")
    if os.path.exists(tail_path):
        with open(tail_path, "rb") as f:
            events_tail = sum(1 for line in f if line.strip())
    return {
        "bundle": bundle_dir,
        "meta": meta,
        "ring": ring,
        "registry": registry,
        "events_tail_lines": events_tail,
        "verified": verified,
        "problems": problems,
    }


def render_postmortem(pm: dict[str, Any]) -> str:
    """Human rendering of :func:`load_postmortem`: the trip header, then the
    ring as a step timeline with anomaly verdicts inline."""
    meta = pm["meta"]
    ring = pm["ring"]
    lines: list[str] = []
    # schema-2 bundles (obs/recorder.py) carry host identity; schema-1 ones
    # predate it and render without the proc/host tag
    ident = ""
    if "proc" in meta:
        ident = (
            f"   proc: {meta['proc']}/{meta.get('world', '?')}"
            f" ({meta.get('host', '?')})"
        )
    lines.append(
        f"postmortem: {meta.get('reason', '?')}   run: "
        f"{meta.get('run', '?')}{ident}   bundle: {pm['bundle']}"
    )
    trip = {
        k: v for k, v in meta.items()
        if k not in ("schema", "reason", "run", "capacity", "steps",
                     "dumped_ts", "proc", "world", "host", "anchors",
                     "flush_error")
    }
    if trip:
        lines.append(
            "trip: " + "   ".join(f"{k}={v}" for k, v in sorted(trip.items()))
        )
    if meta.get("flush_error"):
        # the dump-time flush failing IS evidence (the ring predates the
        # trip by one flush) — front and center, not buried in raw meta
        lines.append(
            f"FLUSH FAILED at dump time: {meta['flush_error']} — ring below "
            "is stale by up to one flush interval"
        )
    if ring:
        lines.append(
            f"ring: {len(ring)} step(s) of {meta.get('capacity', '?')} "
            f"(steps {ring[0]['step']}..{ring[-1]['step']})"
        )
    else:
        lines.append("ring: empty (tripped before any recorded step)")
    lines.append(
        "integrity: "
        + ("manifest verified (sha256)" if pm["verified"] else
           "NOT verified — " + "; ".join(pm["problems"]))
    )
    counters = (pm.get("registry") or {}).get("counters", {})
    anomaly_counts = {
        k.rsplit(".", 1)[1]: v for k, v in counters.items()
        if k.startswith("obs.anomaly.")
    }
    if anomaly_counts:
        lines.append(
            "anomalies (run totals): " + ", ".join(
                f"{k}={int(v)}" for k, v in sorted(anomaly_counts.items())
            )
        )
    if pm["events_tail_lines"]:
        lines.append(f"events tail: {pm['events_tail_lines']} line(s)")
    if not ring:
        return "\n".join(lines)

    # timeline: one row per ring record, the trip-relevant scalars first,
    # anomaly verdicts flagged inline
    lines.append("")
    t0 = ring[0].get("ts")
    hdr = (f"{'step':>6} {'phase':<4} {'t+s':>8} {'loss':>10} "
           f"{'grad_norm':>10} {'reward':>8}  anomalies / extras")
    lines.append(hdr)
    lines.append("-" * len(hdr))

    def num(rec, *keys):
        for k in keys:
            v = rec.get(k)
            if isinstance(v, (int, float)):
                return v
        return None

    def cell(v, width, prec=4):
        return f"{v:>{width}.{prec}g}" if v is not None else " " * width

    for rec in ring:
        dt = (rec["ts"] - t0) if (t0 is not None and "ts" in rec) else None
        anomalies = rec.get("anomalies") or []
        extras = []
        ent = num(rec, "sample_entropy")
        if ent is not None:
            extras.append(f"entropy={ent:.2f}")
        upd = num(rec, "upd_ratio/global")
        if upd is not None:
            extras.append(f"upd={upd:.2e}")
        flag = (" <-- " + ",".join(anomalies)) if anomalies else ""
        tail = "  ".join(extras)
        lines.append(
            f"{rec.get('step', '?'):>6} {rec.get('phase', ''):<4} "
            f"{cell(dt, 8, 3)} {cell(num(rec, 'loss', 'rl_loss'), 10)} "
            f"{cell(num(rec, 'grad_norm'), 10)} "
            f"{cell(num(rec, 'reward_mean'), 8)}  {tail}{flag}"
        )
    probe = ring[-1].get("probe")
    if probe:
        lines.append("")
        lines.append(
            "last probe: " + "   ".join(
                f"{k}={v:g}" for k, v in sorted(probe.items())
            )
        )
    return "\n".join(lines)


# ---- bundle discovery under a run dir ----------------------------------------

_BUNDLE_RE = re.compile(r"^postmortem_\d+_.+")


def discover_bundles(run_dir: str) -> dict[int, list[str]]:
    """Map proc index -> its postmortem bundle dirs (dump order). Process 0
    dumps into ``run_dir`` itself, process k into ``run_dir/proc<k>/``
    (the JAX package's multi-host layout)."""
    out: dict[int, list[str]] = {}

    def scan(d: str, proc: int) -> None:
        try:
            names = os.listdir(d)
        except OSError:
            return
        found = sorted(
            os.path.join(d, n) for n in names
            if _BUNDLE_RE.match(n) and os.path.isdir(os.path.join(d, n))
        )
        if found:
            out[proc] = found

    scan(run_dir, 0)
    try:
        entries = sorted(os.listdir(run_dir))
    except OSError:
        entries = []
    for entry in entries:
        m = _PROC_DIR_RE.match(entry)
        if m:
            scan(os.path.join(run_dir, entry), int(m.group(1)))
    return out


def list_bundles(run_dir: str) -> list[dict[str, Any]]:
    """Every bundle under a run dir with its trip kind and step (the
    ``obs_report --postmortem <dir> --list`` view; rows as the JAX
    package's)."""
    rows: list[dict[str, Any]] = []
    for proc, dirs in sorted(discover_bundles(run_dir).items()):
        for d in dirs:
            meta: dict = {}
            try:
                with open(os.path.join(d, "meta.json"),
                          encoding="utf-8") as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                pass
            verified, _ = _verify_bundle(d)
            rows.append({
                "proc": proc,
                "bundle": d,
                "reason": meta.get("reason", "?"),
                "step": meta.get("step"),
                "phase": meta.get("phase"),
                "host": meta.get("host"),
                "ring_steps": len(meta.get("steps", [])),
                "dumped_ts": meta.get("dumped_ts"),
                "verified": verified,
            })
    return rows
