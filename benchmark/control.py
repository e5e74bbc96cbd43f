"""The evidence behind the limits and the batch sizes, read on the chip.

    python -m benchmark.control readings --workload <cell> \\
        --seeds 1,2,... [--control-seeds ...] [--fault-seeds ...] \\
        [--out chiprun_out/<file>.jsonl]
    python -m benchmark.control sweep --workload <cell> \\
        --batches 64,128,256,512 [--seconds 10] [--out ...]

``readings`` runs, in one process, the cell's first steps through the
timed path for each seed and judges them (the lower readings); then the
control: the reference itself, computed one precision below the
configuration's bfloat16 (float8 e4m3 operands,
``reference.model.fp8_round``), put in the port's place and judged the
same way (the upper readings); then each fault of the kind's ``FAULTS``
on the fault seeds. Each reading is one JSON line.

``sweep`` runs the cell at each batch: an untraced window for the rate,
a traced one for the device's idle share, and the peak of
``torch.cuda.max_memory_allocated()``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import cells, guard, kinds
from benchmark.run import RunArgs


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def program_capture(cell, seed: int, device: str, tmp: Path):
    """The timed path's first steps for ``seed``."""
    args = RunArgs(device, seed, 0.0, False, tmp, time.perf_counter())
    return kinds.load(cell.kind).drive(cell, args).capture


def readings(a, overrides: dict | None = None) -> None:
    cell = cells.Cell(a.workload, overrides)
    torch.set_num_threads(cell.threads)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    tmp = Path(a.tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    out = open(a.out, "a") if a.out else None
    kind = kinds.load(cell.kind)

    def emit(what, seed, t0, r):
        line = {"cell": a.workload, "what": what, "seed": seed,
                "s": round(time.perf_counter() - t0, 2), **r}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    plan = [("program", s) for s in _seeds(a.seeds)]
    plan += [("control", s) for s in _seeds(a.control_seeds)]
    for f in kind.FAULTS:
        if f == "unchanged":
            continue     # reads 1 by the leaf measure and needs no run
        plan += [(f, s) for s in _seeds(a.fault_seeds)]
    for what, seed in plan:
        t0 = time.perf_counter()
        cell.seed = seed
        if what == "program":
            cap = program_capture(cell, seed, dev, tmp)
        elif what == "control":
            cap = kind.control(cell, seed, dev)
        else:
            with kind.FAULTS[what]():
                cap = program_capture(cell, seed, dev, tmp)
        emit(what, seed, t0, kind.judge(cell, cap, dev))
        del cap
        if dev == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()


def sweep(a) -> None:
    from benchmark.run import run

    dev = "cuda"
    for b in _seeds(a.batches):
        for trace in (False, True):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            line = run(a.workload, 7_000_000_000 + b, a.seconds, trace, dev,
                       t0, overrides={"workload": {"batch": b}}, judge=False)
            rec = {"cell": a.workload, "batch": b, "trace": trace,
                   "wall_s": round(time.perf_counter() - t0, 1),
                   "attempted": line["attempted"],
                   "metrics": {k: v["value"]
                               for k, v in line["metrics"].items()},
                   "device": line["device"]}
            print(json.dumps(rec), flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", default="")
    r.add_argument("--control-seeds", default="")
    r.add_argument("--fault-seeds", default="")
    r.add_argument("--out", default="")
    r.add_argument("--tmp", default="chiprun_out/tmp")
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--batches", default="64,128,256,512")
    s.add_argument("--seconds", type=float, default=10.0)
    s.add_argument("--out", default="")
    a = ap.parse_args(argv)
    guard.check("start")
    (readings if a.cmd == "readings" else sweep)(a)
    guard.check("end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
