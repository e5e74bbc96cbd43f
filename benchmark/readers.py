"""The per-layer metrics' shared arithmetic; each metric's own reader
(``metrics/<name>.py``) calls one of these with its parameters and
returns None where its cell has nothing for it to read.

``ctx`` holds ``session`` (``drivers.Session``), ``cell``, ``dims``
(``work.Dims``) and ``device`` (the card's name).
"""

from __future__ import annotations

from benchmark import trace, work

MAIN = "MainThread"


def span_ms(ctx, name: str) -> float | None:
    """Milliseconds a counted step of the main thread's ``name`` spans
    that end inside the window."""
    s = ctx["session"]
    lo, hi = s.t_window
    if not s.steps or not s.spans:
        return None
    tot = sum(t1 - t0 for n, t0, t1, th in s.spans
              if n == name and th == MAIN and lo < t1 <= hi)
    return tot / s.steps * 1e3 if tot > 0 else None


def idle_pct(ctx) -> float | None:
    tr = ctx["session"].trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(ctx, kernels, launch_key: str, work_fn) -> float | None:
    """Least time of the traced window's launches of a kernel (each
    launch's work from ``work_fn(ctx) -> (ops, bytes)``) over the device
    seconds of its kernels, in percent."""
    s = ctx["session"]
    n = s.trace_counters.get(launch_key, 0)
    secs = trace.kernel_seconds(s.trace, kernels)
    if not n or not secs or work.peaks(ctx["device"]) is None:
        return None
    ops, nbytes = work_fn(ctx)
    return 100.0 * n * work.least_seconds(ops, nbytes, ctx["device"]) / secs


def mfu_pct(ctx, flops: float) -> float | None:
    """``flops`` of the counted window over its seconds and the bf16
    peak, in percent."""
    s = ctx["session"]
    pk = work.peaks(ctx["device"])
    if pk is None or not s.window_s or not flops:
        return None
    return 100.0 * flops / s.window_s / pk[0]
