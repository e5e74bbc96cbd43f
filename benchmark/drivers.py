"""What the drivers of ``kinds/<kind>.py`` share: the window that counts
whole steps, the session a driver hands back, the obs spans of a traced
run, the program's model with the seed's weights, and the pool as the
port's dataset.

A driver builds one object from the seed, drives it through its first
``WARMUP_STEPS`` steps (set-up; the correctness check captures steps
1-3), then measures whole steps, each ending in
``torch.cuda.synchronize()``, for at least ``seconds`` (``0``: no
window), and returns a :class:`Session`.
"""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import weights as bw
from benchmark.trace import Tracer

WARMUP_STEPS = 4     # steps before the window: 1-3 checked, 4 steady
CHECK_STEPS = 3      # the reference follows the first three steps


def smi(device) -> str:
    """The card's clocks and power, or why they could not be read."""
    if torch.device(device).type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


@dataclass
class Session:
    """What a driver hands back."""

    setup_s: float = 0.0
    steps: int = 0              # whole steps counted in the window
    units: int = 0              # clips or captions of those steps
    window_s: float = 0.0       # first counted step's start to last's end
    memory_peak: int = 0
    capture: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)   # (name, t0, t1, thread)
    counters: dict = field(default_factory=dict)        # open -> last step
    trace_counters: dict = field(default_factory=dict)  # open -> close
    trace: dict | None = None
    t_window: tuple = (0.0, 0.0)


class Window:
    """Counts whole steps: ``tick()`` after each step (synchronises,
    opens the window after ``warmup`` steps); ``should_stop()`` closes
    it once ``seconds`` have passed."""

    def __init__(self, run, warmup: int, on_open=None):
        self.run = run
        self.cuda = torch.device(run.device).type == "cuda"
        self.warmup = warmup
        self.n = 0
        self.count = 0
        self.t_start = self.t_last = None
        self.stopped = False
        self.on_open = on_open
        self.tracer = None
        # kernel launches at the window's open, last counted step and close
        self.launches = {}
        self.step_s = []        # each counted step's seconds

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def tick(self):
        self.sync()
        self.n += 1
        if self.run.trace and self.n == self.warmup - 1 \
                and self.run.seconds > 0:
            self.tracer = Tracer(self.run.tmp, self.cuda)
            self.tracer.start()
        if self.n < self.warmup:
            self.run.mark(f"step {self.n}")
        if self.n == self.warmup and self.run.seconds > 0:
            self.run.mark(f"step {self.n}")
            print(f"benchmark: window open: {smi(self.run.device)}",
                  file=sys.stderr)
            self.run.mark("nvidia-smi")
            print("benchmark: set-up s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in self.run.phases), file=sys.stderr)
            if self.on_open is not None:
                self.on_open()
            self.launches["open"] = launch_counts()
            if self.tracer is not None:
                self.tracer.open()
            self.t_start = self.t_last = time.perf_counter()
            self.run.setup_s = self.t_start - self.run.t0
        elif self.t_start is not None and not self.stopped:
            self.count += 1
            t = time.perf_counter()
            self.step_s.append(t - self.t_last)
            self.t_last = t
            self.launches["last"] = launch_counts()

    def should_stop(self) -> bool:
        if self.stopped:
            return True
        if self.run.seconds <= 0:
            self.stopped = self.n >= CHECK_STEPS
            return self.stopped
        if self.t_start is None:
            return False
        if time.perf_counter() - self.t_start >= self.run.seconds:
            self.stopped = True
            if self.tracer is not None:
                self.tracer.close()
            self.launches["close"] = launch_counts()
        return self.stopped

    def finish(self, per_step: int, spans, capture: dict) -> Session:
        """The session of the closed window: counts, times, peak memory,
        launches, and in a traced run the spans and the profiler's
        summary."""
        sess = Session(capture=capture)
        if self.run.seconds > 0 and self.t_start is not None:
            print(f"benchmark: window closed: {smi(self.run.device)}",
                  file=sys.stderr)
            if self.step_s:
                ms = np.sort(np.asarray(self.step_s)) * 1e3
                q = np.percentile(ms, [10, 50, 90])
                print(f"benchmark: {len(ms)} steps, ms min {ms[0]:.1f} "
                      f"p10 {q[0]:.1f} p50 {q[1]:.1f} p90 {q[2]:.1f} "
                      f"max {ms[-1]:.1f}; in order: "
                      + " ".join(f"{x * 1e3:.0f}" for x in self.step_s),
                      file=sys.stderr)
        sess.setup_s = self.run.setup_s
        sess.steps = self.count
        sess.units = self.count * per_step
        if self.t_start is not None:
            sess.window_s = self.t_last - self.t_start
            sess.t_window = (self.t_start, self.t_last)
        if self.cuda:
            sess.memory_peak = int(torch.cuda.max_memory_allocated())
        got = self.launches
        if "open" in got:
            sess.counters = _diff(got["open"], got.get("last", got["open"]))
            sess.trace_counters = _diff(got["open"],
                                        got.get("close", got["open"]))
        if spans is not None:
            sess.spans = spans.close()
        if self.tracer is not None:
            sess.trace = self.tracer.finish()
        return sess


class Spans:
    """The port's obs spans over the window (traced runs only): a
    recorder configured under the run's temporary directory as the window
    opens, read back from its in-memory trace."""

    def __init__(self, run):
        self.run = run
        self.rec = None

    def open(self):
        from cst_captioning_tpu_torch import obs

        self.rec = obs.configure(str(Path(self.run.tmp) / "obs"), run="bench")

    def close(self) -> list:
        from cst_captioning_tpu_torch import obs

        if self.rec is None:
            return []
        rec = self.rec
        events = list(rec._trace)
        origin = rec._t_origin
        obs.shutdown()
        return [(e["name"], origin + e["ts"] * 1e-6,
                 origin + (e["ts"] + e["dur"]) * 1e-6, e["tid"])
                for e in events]


def launch_counts() -> dict:
    """The launches each kernel wrapper of the port's ``ops`` has counted,
    by its name there."""
    from cst_captioning_tpu_torch import ops

    fns = {n: getattr(ops, n) for n in ops.__all__}
    return {n: f.launches for n, f in fns.items()
            if isinstance(getattr(f, "launches", None), int)}


def _diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def build_model(cell, run):
    """The port's model on the run's device, with the seed's weights;
    -> (model, the weights as drawn)."""
    from cst_captioning_tpu_torch.models.captioner import CaptionModel

    model = CaptionModel(cell.model_config(), device=run.device)
    w0 = bw.make_weights(cell.model, run.seed, run.device)
    bw.load_into(model, w0)
    return model, w0


def dataset(cell, pool: Path):
    from cst_captioning_tpu_torch.data.dataset import CaptionDataset

    from benchmark import corpus

    return CaptionDataset(str(pool / "info.json"),
                          corpus.feature_files(pool, cell.model),
                          split=cell.traffic["split"],
                          max_frames=int(cell.model["max_frames"]))


def endless(batcher, shuffle: bool):
    """The batcher's epochs, one after another."""
    while True:
        yield from batcher.epoch(shuffle=shuffle)


def _named(model, tensors) -> dict:
    return {n: t.detach().float().clone()
            for (n, _), t in zip(model.named_parameters(), tensors)}


def capture_step(win: Window, cap: dict, model, state, loss: float) -> None:
    """What the reference follows of a training step just ticked: the
    first steps' losses, Adam's first moment after step 1 and the
    parameters after step ``CHECK_STEPS``."""
    if win.n <= CHECK_STEPS:
        cap["losses"].append(loss)
    if win.n == 1:
        cap["mu1"] = _named(model, state.opt_state["mu"])
    if win.n == CHECK_STEPS:
        cap["p3"] = _named(model, model.parameters())
