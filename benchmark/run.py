"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the port's obs spans and torch.profiler over a
window of at most ``TRACE_SECONDS``). The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the checks are also the last lines
of standard error. Without a CUDA device, or with fewer than the cell's
chips, it exits with code 2 and prints no result; with ``jax``,
``jaxlib``, ``flax`` or the JAX package loaded after the window, code 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the run's set-up starts here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import guard  # noqa: E402

TRACE_SECONDS = 10.0
ROOT = Path(__file__).resolve().parent


@dataclass
class RunArgs:
    device: str
    seed: int
    seconds: float
    trace: bool
    tmp: Path
    t0: float
    setup_s: float = 0.0
    # (phase, seconds since the last mark): set-up timed part by part
    phases: list = field(default_factory=list)
    t_mark: float = 0.0

    def mark(self, phase: str) -> None:
        t = time.perf_counter()
        self.phases.append((phase, t - (self.t_mark or self.t0)))
        self.t_mark = t


def reader(metric: str):
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, key: str) -> list[dict]:
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]


def run(name: str, seed: int, seconds: float, trace: bool, device: str,
        t0: float, overrides: dict | None = None,
        manifest: dict | None = None, judge: bool = True,
        phases: list | None = None) -> dict:
    """One run of cell ``name`` -> its result line (a dict); ``judge``
    False skips the reference (the batch sweep); ``phases``: the set-up
    already timed, ``(phase, seconds)``, continued by this run's."""
    import torch

    from benchmark import cells, checks, kinds, work

    manifest = manifest or cells.manifest()
    cell = cells.Cell(name, overrides)
    cell.seed = int(seed)
    torch.set_num_threads(cell.threads)
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        args = RunArgs(device, int(seed),
                       min(seconds, TRACE_SECONDS) if trace else seconds,
                       bool(trace), tmp, t0, phases=list(phases or []))
        args.t_mark = t0 + sum(v for _, v in args.phases)
        args.mark("harness")
        kind_mod = kinds.load(cell.kind)
        sess = kind_mod.drive(cell, args)
        kind = (torch.cuda.get_device_name(0)
                if torch.device(device).type == "cuda" else "cpu")
        ctx = {"session": sess, "cell": cell,
               "dims": work.Dims.of(cell.model), "device": kind}
        metrics = {}
        if trace:
            for m in cell_metrics(manifest, name, "per_layer"):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            rate = sess.units / sess.window_s if sess.window_s else 0.0
            for m in cell_metrics(manifest, name, "end_to_end"):
                v = sess.setup_s if m["name"] == "setup_s" else rate
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info = {"platform": "gpu" if kind != "cpu" else "cpu",
                       "kind": kind, "count": 1,
                       "memory_peak_bytes": sess.memory_peak}
        line = {"correct": False, "attempted": sess.units, "failed": 0,
                "metrics": metrics, "device": device_info}
        if trace and sess.trace:
            device_info["busy_s"] = sess.trace["busy_s"]
            device_info["window_s"] = sess.trace["window_s"]
            line["breakdown"] = {"device_ops": sess.trace["ops"],
                                 "idle_gaps": sess.trace["gaps"]}
        cap = sess.capture
        del sess, ctx
        if not judge:
            line["checks"] = {}
            return line
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        readings = kind_mod.judge(cell, cap, device)
        ok, line["checks"] = checks.verdict(readings,
                                            cell.workload["limits"])
        line["correct"] = ok
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    guard.check("start")
    import torch

    from benchmark import cells

    phases = [("import torch", time.perf_counter() - T0)]

    manifest = cells.manifest()
    cell = [w for w in manifest["workloads"] if w["name"] == a.workload]
    if not cell:
        print(f"benchmark: no workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = int(cell[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    phases.append(("cuda init", time.perf_counter() - T0 - phases[0][1]))
    line = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", T0,
               manifest=manifest, phases=phases)
    guard.check("after the window")
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
