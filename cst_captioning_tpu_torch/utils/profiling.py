"""torch.profiler trace capture around a window of training steps (the JAX
package's ``utils/profiling.py``).

A trace of N steps past the first ones is written as a Chrome trace
(``<out_dir>/trace.json``, viewable in Perfetto or chrome://tracing),
wired through ``TrainConfig.profile_dir`` / ``--profile``. On the card it
holds the CPU ops and every CUDA kernel the process launched in the
window, the port's own kernels (loaded with ctypes) under their C++
symbol names included.

Observability wiring (obs/ package): the capture window opens an obs span on
the ``profiler`` virtual track, so the window shows up on the run timeline
next to the step spans it overlaps, and completion is announced as a
structured ``profiler_trace_written`` event (through the caller's event
logger when given one, and into the obs stream).
"""

from __future__ import annotations

import os
from typing import Callable

from cst_captioning_tpu_torch import obs

TRACE_FILE = "trace.json"


class StepProfiler:
    """Trace steps ``skip+1 .. skip+steps`` (1-based) of a loop.

    ``tick()`` is called once per finished training step; the profiler runs
    under ``torch.profiler.schedule(wait=skip, warmup=0, active=steps)``,
    so the first ``skip`` steps (the kernel builds, the cuBLAS warm-up)
    stay out of the trace. Safe to leave in hot loops when disabled
    (``out_dir=""`` -> every tick is a no-op).

    ``log(event, **fields)`` (an ``EventLogger.log`` works as-is) receives
    the ``profiler_trace_written`` completion event; the obs stream gets a
    copy regardless, so run reports can count capture windows.
    """

    def __init__(self, out_dir: str, steps: int = 10, skip: int = 1,
                 log: Callable[..., None] | None = None):
        self.out_dir = out_dir
        self.steps = steps
        self.skip = skip
        self._log = log
        self._count = 0
        self._prof = None
        self._span: obs.Span | None = None
        self._written = False
        self._done = not out_dir

    def tick(self) -> None:
        if self._done:
            return
        if self._prof is None:
            self._start()
        self._count += 1
        self._prof.step()
        if self._count == self.skip and self.steps > 0:
            # virtual track: the window spans several steps, so it must not
            # join the caller thread's (properly nested) span stack
            self._span = obs.span(
                "profile.window", track="profiler", dir=self.out_dir
            ).begin()
        elif self._count >= self.skip + self.steps:
            self.stop()

    def _start(self) -> None:
        import warnings

        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with warnings.catch_warnings():
            # warmup=0 is deliberate: the window starts right after `skip`
            warnings.simplefilter("ignore")
            self._prof = profile(
                activities=activities,
                schedule=schedule(wait=self.skip, warmup=0,
                                  active=self.steps, repeat=1),
                on_trace_ready=self._ready)
        self._prof.start()

    def _ready(self, prof) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out_dir, TRACE_FILE))
        self._written = True

    def stop(self) -> None:
        """Finalize the trace (also called when an epoch ends mid-window)."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
            if self._span is not None:
                self._span.end()
                self._span = None
            if self._written:
                fields = {"dir": self.out_dir, "steps": self.steps}
                obs.event("profiler_trace_written", **fields)
                if self._log is not None:
                    self._log("profiler_trace_written", **fields)
        self._done = True
