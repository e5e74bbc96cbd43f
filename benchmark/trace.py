"""The traced run's device view: torch.profiler over the measured window,
reduced to busy seconds, kernel seconds by name and the longest idle
gaps.

The window is marked by a ``bench.window`` user annotation from its
first to its last step; device activity (kernels, copies, sets) is
clipped to it. A gap between device intervals is labelled with the
shortest host operation that covers its middle (``host`` where none
does: Python between operations).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.window"


class Tracer:
    """Start with :meth:`start` a step before the window, mark the window
    with :meth:`open` / :meth:`close`, and :meth:`finish` after the run's
    work to write and read the trace."""

    def __init__(self, out_dir: Path, cuda: bool):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.out = Path(out_dir) / "trace.json"
        self._rf = None
        self.summary = None

    def start(self):
        self.prof.__enter__()

    def open(self):
        import torch

        self._rf = torch.profiler.record_function(MARK)
        self._rf.__enter__()

    def close(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def finish(self) -> dict | None:
        self.close()
        self.prof.__exit__(None, None, None)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.out))
        try:
            self.summary = summarize(json.loads(self.out.read_text()))
        finally:
            os.unlink(self.out)
        return self.summary


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi) outside the union of
    ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _drop_groups(text: str, open_: str, close: str) -> str:
    """``text`` without its bracketed groups (nested ones included)."""
    out, depth = [], 0
    for ch in text:
        if ch == open_:
            depth += 1
        elif ch == close and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and
    template arguments, at most 64 characters: ``void (anonymous
    namespace)::k<float, 3>(Args)`` -> ``(anonymous namespace)::k``."""
    base = name.strip()
    if base.endswith(")"):
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i]
                break
    base = _drop_groups(base, "<", ">").strip()
    if base.startswith("void "):
        base = base[5:]
    return base.strip()[:64] or name[:64]


def summarize(doc: dict) -> dict | None:
    """A chrome trace -> ``{"window_s", "busy_s", "kernels": {short name:
    s}, "ops": [[name, s], ...] (top 10), "gaps": [[label, s], ...]
    (top 10)}``, or None without a window mark or device activity."""
    events = doc.get("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, host = [], []
    kernels: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            dev.append((s, t))
            key = short_name(e.get("name", "?"))
            kernels[key] = kernels.get(key, 0.0) + (t - s) * 1e-6
        elif cat == "cpu_op" and t > lo and s < hi:
            host.append((s, t, e.get("name", "?")))
    if not dev:
        return None
    idle = gaps(dev, lo, hi)
    idle.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in idle[:10]:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[0] <= mid < h[1]]
        label = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host"
        labelled.append([label[:64], (e - s) * 1e-6])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": union_seconds(dev) * 1e-6,
            "kernels": kernels,
            "ops": [[k, v] for k, v in ops],
            "gaps": labelled}


def kernel_seconds(summary: dict | None, names) -> float | None:
    """Seconds of the kernels whose short name contains any of
    ``names``; None without a trace or without such a kernel."""
    if not summary:
        return None
    total = sum(s for k, s in summary["kernels"].items()
                if any(n in k for n in names))
    return total if total > 0 else None
