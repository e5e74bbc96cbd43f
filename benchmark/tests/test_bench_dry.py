"""Each cell's whole command path at a tiny size on the CPU, with the
port's plain versions: a sound run comes out correct, every planted
fault of the cell comes out not correct, and the control (the reference
in float8) reads above a sound run. The same paths at the cells' own
sizes run on the card (``gpu``)."""

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import cells, checks, control, kinds
from benchmark import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
TINY = {"model": {"vocab_size": 300, "modalities": [["resnet", 16],
                                                    ["c3d", 12]],
                  "d_embed": 32, "d_hidden": 32, "d_att": 16,
                  "max_frames": 6, "max_len": 20},
        "data": {"train_clips": 32, "test_clips": 64,
                 "captions_per_clip": 4},
        "workload": {"batch": 4, "threads": 2}}
CELLS = [w["name"] for w in cells.manifest()["workloads"]]
SEED = 4_294_967_311      # past 32 bits
# The limits at this size, between this seed's sound readings on the CPU
# (loss_gap 2.7e-6, grad_gap 5.1e-3, change_gap 1.9e-3, rollout_gap 0)
# and its control's (9.3e-5, 1.1e-2, 1.6e-2, 4.6e-3): the cells' own
# limits come from the card at the cells' sizes.
TINY_LIMITS = {
    "cst_msrvtt": {"feed_order": 0.0, "loss_gap": 3e-5, "grad_gap": 8e-3,
                   "change_gap": 6e-3, "rollout_gap": 1e-3,
                   "reward_gap": 1e-5},
}


def tiny(cell: str) -> dict:
    ov = copy.deepcopy(TINY)
    ov["workload"]["limits"] = TINY_LIMITS[cell]
    return ov


@pytest.fixture(autouse=True)
def pool_dir(tmp_path, monkeypatch):
    from benchmark import corpus

    monkeypatch.setattr(corpus, "DATA_DIR", tmp_path / "_data")
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def run_tiny(cell, trace=False, seconds=0.5):
    return bench_run.run(cell, SEED, seconds, trace, "cpu",
                         time.perf_counter(), overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    line = run_tiny(cell, trace)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0
    man = cells.manifest()
    key = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench_run.cell_metrics(man, cell, key)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())


def kind_of(cell: str):
    return kinds.load(cells.Cell(cell).kind)


FAULT_CASES = [(c, f) for c in CELLS for f in kind_of(c).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULT_CASES,
                         ids=[f"{c}-{f}" for c, f in FAULT_CASES])
def test_planted_fault_is_not_correct(cell, fault):
    with kind_of(cell).FAULTS[fault]():
        line = run_tiny(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    """The reference in float8 in the port's place fails the limits that
    the sound run meets."""
    c = cells.Cell(cell, tiny(cell))
    c.seed = SEED
    kind = kinds.load(c.kind)
    ctl = kind.judge(c, kind.control(c, SEED, "cpu"), "cpu")
    sound = kind.judge(c, control.program_capture(c, SEED, "cpu", tmp_path),
                       "cpu")
    limits = c.workload["limits"]
    assert checks.verdict(sound, limits)[0], sound
    assert not checks.verdict(ctl, limits)[0], ctl


def test_readings_tool_writes_lines(tmp_path, capsys):
    a = argparse.Namespace(workload="cst_msrvtt", seeds="1",
                           control_seeds="2", fault_seeds="3",
                           out=str(tmp_path / "r.jsonl"),
                           tmp=str(tmp_path / "t"))
    control.readings(a, tiny("cst_msrvtt"))
    lines = [json.loads(x) for x in (tmp_path / "r.jsonl").read_text()
             .splitlines()]
    # "unchanged" reads 1 by the leaf measure and needs no run
    faults = [f for f in kind_of("cst_msrvtt").FAULTS if f != "unchanged"]
    assert [x["what"] for x in lines] == ["program", "control", *faults]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
