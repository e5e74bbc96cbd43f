"""Fleet postmortem: the latest flight-recorder bundle of every process
merged onto one skew-corrected timeline (the JAX package's
``obs/fleet.py``).

A multi-process run fails as a fleet: the host that tripped first, the
straggler, and the DCN stall before the drain sit in N bundles (process
0's in the obs run dir, process k's under ``proc<k>/``, the layout of the
span streams). :func:`merge_bundles` makes one forensic of them:

- verify: each bundle's ``manifest.json`` is checked (sha256 and size); a
  tampered or truncated bundle is excluded and reported, never merged;
- anchor: schema-2 bundles carry monotonic/wall anchor pairs, and ring
  timestamps are re-mapped through the whole table, so a wall-clock step
  during the run does not skew the alignment; a bundle without anchors
  merges with ``skew="unknown"``;
- align: rings join on the global ``(phase, step)`` key; each process's
  clock offset against the reference process is the median of the
  per-key deltas;
- attribute: the trip is the first record in corrected time with a
  non-finite or anomaly verdict; per-step lag names the straggler;
  ``dcn_stall`` / ``anomaly`` / drain events of each bundle's
  ``events_tail`` interleave at corrected times; ``lost`` / ``victim_host``
  meta names the victims; ``mesh_shrink`` / ``mesh_regrow`` events pair
  into an elastic section;
- degrade: a process with no bundle is listed in ``missing_procs`` and
  the survivors still merge.

The merged dict and :func:`render_fleet`'s text equal the JAX package's
on the same bundles. Stdlib only, on top of :mod:`obs.report` (which
finds and lists the bundles).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any, Callable

from cst_captioning_tpu_torch.obs.report import (
    discover_bundles,
    list_bundles,
    load_postmortem,
)

__all__ = ["discover_bundles", "list_bundles", "merge_bundles",
           "render_fleet", "select_latest"]

# events_tail kinds worth a fleet-timeline row (the rest of the tail is
# span traffic the run report already aggregates)
_FLEET_EVENTS = (
    "dcn_stall", "anomaly", "divergence", "preempt", "peer_loss_drain",
    "serving_drain", "postmortem",
    "mesh_shrink", "mesh_regrow", "regrow_refused",
    "serving_param_swap", "serving_param_swap_refused",
)
_MAX_FLEET_EVENTS = 200


# ---- selection ---------------------------------------------------------------

def select_latest(found: dict[int, list[str]]) -> dict[int, str]:
    """Latest bundle per proc — bundle names carry the per-process dump
    ordinal (``postmortem_<n>_<reason>``), so lexicographic order within a
    proc dir IS dump order."""
    return {proc: dirs[-1] for proc, dirs in found.items()}


# ---- skew model --------------------------------------------------------------

def _anchor_fn(meta: dict) -> Callable[[float], float] | None:
    """Piecewise-linear monotonic↔wall map from a schema-2 bundle's anchor
    table, applied to ring ``ts`` values (which the recorder derived from
    the START anchor alone). ``None`` for anchor-free legacy bundles."""
    anchors = meta.get("anchors")
    if not anchors:
        return None
    try:
        pts = sorted((float(p), float(w)) for p, w in anchors)
    except (TypeError, ValueError):
        return None
    if not pts:
        return None
    pc0, wall0 = pts[0]

    def fn(ts: float) -> float:
        # invert the recorder's ts = wall0 + (pc - pc0), then re-map pc
        # through the freshest bracketing anchor pair
        pc = pc0 + (ts - wall0)
        if pc <= pts[0][0]:
            return pts[0][1] + (pc - pts[0][0])
        for (p1, w1), (p2, w2) in zip(pts, pts[1:]):
            if pc <= p2:
                if p2 <= p1:
                    return w2
                f = (pc - p1) / (p2 - p1)
                return w1 + f * (w2 - w1)
        pl, wl = pts[-1]
        return wl + (pc - pl)

    return fn


def _ring_keyed(pm: dict) -> dict[tuple[str, int], dict]:
    """Ring records keyed by the global (phase, step) join key; the LAST
    record wins when a step re-ran (rollback replay)."""
    out: dict[tuple[str, int], dict] = {}
    for rec in pm["ring"]:
        step = rec.get("step")
        if isinstance(step, int):
            out[(str(rec.get("phase", "")), step)] = rec
    return out


def _is_nonfinite(v: Any) -> bool:
    if not isinstance(v, (int, float)):
        return False
    return v != v or v in (float("inf"), float("-inf"))


# ---- the merge ---------------------------------------------------------------

def merge_bundles(run_dir: str) -> dict[str, Any]:
    """Verify + merge the latest bundle of every proc under ``run_dir``
    into the fleet forensic structure (JSON-ready; ``render_fleet`` is the
    human view). Raises ``FileNotFoundError`` when no bundles exist."""
    found = discover_bundles(run_dir)
    if not found:
        raise FileNotFoundError(
            f"no postmortem bundles under {run_dir!r} — expected "
            "postmortem_* dirs (proc 0) and/or proc<k>/postmortem_* "
            "(obs/recorder.py layout)"
        )
    latest = select_latest(found)

    procs: dict[int, dict] = {}
    excluded: list[dict] = []
    for proc, bdir in sorted(latest.items()):
        pm = load_postmortem(bdir)
        if not pm["verified"]:
            # tampered/truncated evidence is worse than missing evidence:
            # report it, never merge it
            excluded.append({
                "proc": proc,
                "bundle": bdir,
                "problems": pm["problems"],
            })
            continue
        procs[proc] = pm

    # expected world size: the largest claim any bundle makes, or the
    # largest proc index actually seen — whichever is bigger
    world = max(
        [p + 1 for p in found]
        + [int(pm["meta"].get("world", 1)) for pm in procs.values()]
    )
    present = set(procs) | {e["proc"] for e in excluded}
    missing_procs = sorted(set(range(world)) - present)

    fleet: dict[str, Any] = {
        "run_dir": run_dir,
        "run": "?",
        "world": world,
        "merged_procs": sorted(procs),
        "missing_procs": missing_procs,
        "excluded": excluded,
        "degraded": bool(missing_procs or excluded),
    }
    if not procs:
        # every bundle failed verification: still a (maximally degraded)
        # answer, not a crash
        fleet.update(procs_info=[], trip=None, straggler=None, steps=[],
                     events=[], victim_hosts=[])
        return fleet

    ref = min(procs)
    fleet["run"] = procs[ref]["meta"].get("run", "?")

    # per-proc anchored timestamps + cross-proc offsets (proc<k> skew model:
    # median delta over shared join keys against the reference proc)
    keyed = {p: _ring_keyed(pm) for p, pm in procs.items()}
    anchored: dict[int, dict[tuple[str, int], float]] = {}
    skew_kind: dict[int, str] = {}
    for p, pm in procs.items():
        fn = _anchor_fn(pm["meta"])
        skew_kind[p] = "anchored" if fn is not None else "unknown"
        anchored[p] = {
            key: (fn(rec["ts"]) if fn is not None else float(rec["ts"]))
            for key, rec in keyed[p].items()
            if isinstance(rec.get("ts"), (int, float))
        }
    offsets: dict[int, float] = {ref: 0.0}
    for p in procs:
        if p == ref:
            continue
        if skew_kind[p] == "unknown" or skew_kind[ref] == "unknown":
            # a clock we can't trust gets no offset model — its rows still
            # join by step, but lag attribution is withheld
            offsets[p] = 0.0
            skew_kind[p] = "unknown"
            continue
        shared = sorted(set(anchored[p]) & set(anchored[ref]))
        if not shared:
            offsets[p] = 0.0
            skew_kind[p] = "unknown"
            continue
        offsets[p] = statistics.median(
            anchored[p][k] - anchored[ref][k] for k in shared
        )

    corrected: dict[int, dict[tuple[str, int], float]] = {
        p: {k: ts - offsets[p] for k, ts in anchored[p].items()}
        for p in procs
    }

    # fleet t0: earliest corrected ring timestamp anywhere
    all_ts = [ts for per in corrected.values() for ts in per.values()]
    t0 = min(all_ts) if all_ts else 0.0
    fleet["t0"] = t0

    # join: one row per (phase, step), ordered by earliest corrected time
    keys = sorted(
        {k for per in keyed.values() for k in per},
        key=lambda k: (
            min((corrected[p][k] for p in procs if k in corrected[p]),
                default=float("inf")),
            k,
        ),
    )
    lags: dict[int, list[float]] = {p: [] for p in procs}
    steps: list[dict] = []
    for key in keys:
        phase, step = key
        cells: dict[str, dict] = {}
        row_ts = [
            corrected[p][key] for p in procs
            if key in corrected[p] and skew_kind[p] == "anchored"
        ]
        row_min = min(row_ts) if row_ts else None
        for p, per in keyed.items():
            rec = per.get(key)
            if rec is None:
                continue
            loss = rec.get("loss", rec.get("rl_loss"))
            lag = None
            if (row_min is not None and len(row_ts) >= 2
                    and skew_kind[p] == "anchored" and key in corrected[p]):
                lag = corrected[p][key] - row_min
                lags[p].append(lag)
            cells[str(p)] = {
                "t_s": (
                    corrected[p][key] - t0 if key in corrected[p] else None
                ),
                "loss": loss,
                "grad_norm": rec.get("grad_norm"),
                "reward_mean": rec.get("reward_mean"),
                "anomalies": list(rec.get("anomalies") or []),
                "lag_s": lag,
            }
        steps.append({"phase": phase, "step": step, "cells": cells})
    fleet["steps"] = steps

    # straggler: the proc whose corrected row times trail the fleet most
    straggler = None
    scored = [
        (sum(v) / len(v), max(v), p) for p, v in lags.items() if v
    ]
    if scored:
        mean_lag, max_lag, p = max(scored)
        # sub-millisecond "lag" is clock-resolution noise, not a straggler
        if mean_lag > 1e-3:
            straggler = {
                "proc": p,
                "host": procs[p]["meta"].get("host", "?"),
                "mean_lag_s": mean_lag,
                "max_lag_s": max_lag,
            }
    fleet["straggler"] = straggler

    # trip attribution: first verdict-carrying ring record in corrected
    # time; bundles whose rings never judged (detector off) fall back to
    # their meta reason at dump time
    trip = None
    for p, pm in sorted(procs.items()):
        for rec in pm["ring"]:
            key = (str(rec.get("phase", "")), rec.get("step"))
            kinds = list(rec.get("anomalies") or [])
            if not kinds and _is_nonfinite(
                rec.get("loss", rec.get("rl_loss"))
            ):
                kinds = ["nonfinite"]
            if not kinds:
                continue
            ts = corrected[p].get(key)
            if ts is None:
                ts = float(rec.get("ts", 0.0)) - offsets[p]
            cand = {
                "proc": p,
                "host": pm["meta"].get("host", "?"),
                "phase": key[0],
                "step": rec.get("step"),
                "t_s": ts - t0,
                "kinds": kinds,
                "reason": pm["meta"].get("reason", "?"),
                "source": "ring",
            }
            if trip is None or ts - t0 < trip["t_s"]:
                trip = cand
            break  # first verdict per proc is that proc's candidate
    if trip is None:
        # no ring verdicts anywhere: earliest dump wins, meta is the story
        dumped = [
            (float(pm["meta"].get("dumped_ts", 0.0)) - offsets[p], p)
            for p, pm in procs.items()
        ]
        _, p = min(dumped)
        meta = procs[p]["meta"]
        trip = {
            "proc": p,
            "host": meta.get("host", "?"),
            "phase": meta.get("phase"),
            "step": meta.get("step"),
            "t_s": None,
            "kinds": [meta.get("reason", "?")],
            "reason": meta.get("reason", "?"),
            "source": "meta",
        }
    fleet["trip"] = trip

    # victims: peer-loss bundles name lost hosts, chaos partial_preempt
    # bundles name the injected victim
    victims: set = set()
    for pm in procs.values():
        meta = pm["meta"]
        lost = meta.get("lost")
        if isinstance(lost, list):
            victims.update(lost)
        if "victim_host" in meta:
            victims.add(meta["victim_host"])
    fleet["victim_hosts"] = sorted(victims, key=str)

    # per-proc summary lines (render + --json)
    fleet["procs_info"] = [
        {
            "proc": p,
            "host": pm["meta"].get("host", "?"),
            "bundle": pm["bundle"],
            "reason": pm["meta"].get("reason", "?"),
            "step": pm["meta"].get("step"),
            "ring_steps": len(pm["ring"]),
            "offset_s": offsets[p],
            "skew": skew_kind[p],
            "flush_error": pm["meta"].get("flush_error", ""),
        }
        for p, pm in sorted(procs.items())
    ]

    # serving param-version attribution: procs that served carry a
    # registry "serving" block (engine._drain_postmortem registry_extra)
    # naming the ACTIVE param version at dump plus the recent swap
    # history — a reward/SLO regression in the timeline joins to the
    # version that served it
    serving_att: dict[int, dict] = {}
    for p, pm in sorted(procs.items()):
        sv = (pm.get("registry") or {}).get("serving")
        if isinstance(sv, dict) and "param_version" in sv:
            serving_att[p] = {
                "host": pm["meta"].get("host", "?"),
                "param_version": sv.get("param_version"),
                "param_swaps": sv.get("param_swaps", 0),
                "swap_history": list(sv.get("swap_history") or []),
            }
    fleet["serving"] = serving_att or None

    # events_tail interleave: per-proc obs events (dcn stalls, anomaly
    # verdicts, drains) at offset-corrected times. Tail timestamps are
    # already wall-clock (span stream), so only the cross-host offset
    # applies — no anchor inversion
    events: list[dict] = []
    for p, pm in sorted(procs.items()):
        path = os.path.join(pm["bundle"], "events_tail.jsonl")
        try:
            with open(path, encoding="utf-8") as f:
                tail_lines = f.readlines()
        except OSError:
            continue
        for line in tail_lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("event") not in _FLEET_EVENTS:
                continue
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            out = {
                "t_s": ts - offsets[p] - t0,
                "proc": p,
                "event": ev["event"],
            }
            for k in ("kind", "op", "dur_s", "gap_s", "reason", "step",
                      "phase", "value", "victim", "rejoiner", "generation",
                      "devices", "version", "prev", "active",
                      "inflight_pinned"):
                if k in ev:
                    out[k] = ev[k]
            events.append(out)
    events.sort(key=lambda e: e["t_s"])

    # elastic timeline: pair every mesh_shrink (arc opens, names ONE
    # victim) with the next regrow event naming the same host —
    # mesh_regrow closes the arc (re-admitted), regrow_refused marks a
    # failed attempt and the arc stays open. Computed over the FULL event
    # stream before the tail cap so old arcs survive long runs.
    elastic: list[dict] = []
    open_arcs: dict[Any, dict] = {}
    for ev in events:
        kind = ev["event"]
        if kind == "mesh_shrink":
            arc = {
                "host": ev.get("victim"),
                "shrink_t_s": ev["t_s"],
                "shrink_gen": ev.get("generation"),
                "regrow_t_s": None,
                "regrow_gen": None,
                "outcome": "open",
                "refused": 0,
            }
            elastic.append(arc)
            if arc["host"] is not None:
                open_arcs[arc["host"]] = arc
        elif kind == "regrow_refused":
            arc = open_arcs.get(ev.get("rejoiner"))
            if arc is not None:
                arc["refused"] += 1
        elif kind == "mesh_regrow":
            arc = open_arcs.pop(ev.get("rejoiner"), None)
            if arc is not None:
                arc["regrow_t_s"] = ev["t_s"]
                arc["regrow_gen"] = ev.get("generation")
                arc["outcome"] = "readmitted"
    fleet["elastic"] = elastic
    fleet["events"] = events[-_MAX_FLEET_EVENTS:]
    return fleet


# ---- rendering ---------------------------------------------------------------

def _num(v: Any, width: int = 9, prec: int = 4) -> str:
    if isinstance(v, (int, float)):
        return f"{v:>{width}.{prec}g}"
    return " " * width


def render_fleet(fleet: dict[str, Any]) -> str:
    """Human rendering of :func:`merge_bundles`: per-proc summary, trip /
    straggler / victim attribution, then the per-step timeline with one
    column per host (anomaly verdicts inline, trip marker on the trip
    cell), events interleaved at corrected times."""
    lines: list[str] = []
    n_merged = len(fleet.get("merged_procs", []))
    tag = "  [DEGRADED MERGE]" if fleet.get("degraded") else ""
    lines.append(
        f"fleet postmortem: {fleet.get('run', '?')}   procs merged: "
        f"{n_merged}/{fleet.get('world', n_merged)}   run dir: "
        f"{fleet.get('run_dir', '?')}{tag}"
    )
    for info in fleet.get("procs_info", []):
        off = info["offset_s"]
        lines.append(
            f"  proc{info['proc']} ({info['host']})  "
            f"reason={info['reason']}  ring={info['ring_steps']} step(s)  "
            f"offset={off:+.3f}s ({info['skew']})"
        )
        if info.get("flush_error"):
            lines.append(
                f"    FLUSH FAILED at dump time: {info['flush_error']}"
            )
    if fleet.get("missing_procs"):
        lines.append(
            f"  MISSING PROCS: {fleet['missing_procs']} — no bundle found "
            "(died before first dump, or its disk is gone); merged from "
            "survivors"
        )
    for ex in fleet.get("excluded", []):
        lines.append(
            f"  EXCLUDED proc{ex['proc']}: manifest verification failed "
            f"({'; '.join(ex['problems'])}) — {ex['bundle']}"
        )
    trip = fleet.get("trip")
    if trip:
        at = (
            f" at t+{trip['t_s']:.3f}s" if trip.get("t_s") is not None else ""
        )
        lines.append(
            f"trip: proc{trip['proc']} ({trip['host']}) "
            f"{trip.get('phase') or '?'} step {trip.get('step')}{at} — "
            f"{','.join(trip['kinds'])} [{trip['source']}: {trip['reason']}]"
        )
    if fleet.get("victim_hosts"):
        lines.append(f"victim host(s): {fleet['victim_hosts']}")
    st = fleet.get("straggler")
    if st:
        lines.append(
            f"straggler: proc{st['proc']} ({st['host']})  mean lag "
            f"{st['mean_lag_s']:.3f}s  max {st['max_lag_s']:.3f}s"
        )
    for arc in fleet.get("elastic", []):
        refused = (
            f", {arc['refused']} refused attempt(s)" if arc["refused"] else ""
        )
        if arc["outcome"] == "readmitted":
            span = arc["regrow_t_s"] - arc["shrink_t_s"]
            lines.append(
                f"elastic: host {arc['host']} shrink t+"
                f"{arc['shrink_t_s']:.3f}s --> regrow t+"
                f"{arc['regrow_t_s']:.3f}s (degraded {span:.3f}s, gen "
                f"{arc['shrink_gen']}->{arc['regrow_gen']}{refused})"
            )
        else:
            lines.append(
                f"elastic: host {arc['host']} shrink t+"
                f"{arc['shrink_t_s']:.3f}s --> (never rejoined{refused})"
            )
    for p, sv in sorted((fleet.get("serving") or {}).items()):
        hist = sv.get("swap_history") or []
        arrows = "->".join(
            str(h.get("from")) for h in hist[:1]
        ) + "".join(f"->{h.get('version')}" for h in hist)
        lines.append(
            f"serving: proc{p} ({sv['host']}) active param v"
            f"{sv['param_version']} after {int(sv['param_swaps'])} swap(s)"
            + (f"  [{arrows}]" if hist else "")
        )

    steps = fleet.get("steps", [])
    if not steps:
        lines.append("timeline: no ring records in any merged bundle")
        return "\n".join(lines)

    procs = [info["proc"] for info in fleet.get("procs_info", [])]
    trip_key = (
        (trip.get("phase"), trip.get("step"), trip.get("proc"))
        if trip and trip.get("source") == "ring" else None
    )

    def cell_text(row: dict, p: int) -> str:
        c = row["cells"].get(str(p))
        if c is None:
            return "-"
        bits = [_num(c.get("loss")).strip() or "."]
        if c.get("lag_s") is not None and c["lag_s"] > 1e-3:
            bits.append(f"lag+{c['lag_s']:.3f}")
        if c.get("anomalies"):
            bits.append("<-- " + ",".join(c["anomalies"]))
        if trip_key == (row["phase"], row["step"], p):
            bits.append("[TRIP]")
        return " ".join(bits)

    widths = {
        p: max(
            [len(f"proc{p} loss")]
            + [len(cell_text(row, p)) for row in steps]
        )
        for p in procs
    }
    hdr = f"{'phase':>6} {'step':>6} {'t+s':>9}"
    for p in procs:
        hdr += f" | {f'proc{p} loss':<{widths[p]}}"
    lines.append("")
    lines.append(hdr)
    lines.append("-" * len(hdr))

    # interleave events between step rows by corrected time
    events = list(fleet.get("events", []))
    ev_i = 0

    def row_t(row: dict) -> float | None:
        ts = [
            c["t_s"] for c in row["cells"].values()
            if c.get("t_s") is not None
        ]
        return min(ts) if ts else None

    for row in steps:
        rt = row_t(row)
        while ev_i < len(events) and rt is not None and (
            events[ev_i]["t_s"] <= rt
        ):
            ev = events[ev_i]
            detail = "  ".join(
                f"{k}={ev[k]}"
                for k in ("kind", "op", "dur_s", "reason", "version", "prev")
                if k in ev
            )
            lines.append(
                f"  ~ t+{ev['t_s']:.3f}s proc{ev['proc']} "
                f"{ev['event']} {detail}".rstrip()
            )
            ev_i += 1
        line = (
            f"{row['phase']:>6} {row['step']:>6} "
            f"{_num(rt, 9, 5) if rt is not None else ' ' * 9}"
        )
        for p in procs:
            line += f" | {cell_text(row, p):<{widths[p]}}"
        lines.append(line.rstrip())
    for ev in events[ev_i:]:
        detail = "  ".join(
            f"{k}={ev[k]}" for k in ("kind", "op", "dur_s", "reason")
            if k in ev
        )
        lines.append(
            f"  ~ t+{ev['t_s']:.3f}s proc{ev['proc']} "
            f"{ev['event']} {detail}".rstrip()
        )
    return "\n".join(lines)
