"""BENCHMARK.json against the contract's shape, and every name it holds
resolved to its files."""

import json
import re
from pathlib import Path

import pytest

from benchmark import cells, kinds

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expansion|experts_per)")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert all(TEXT.match(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_texts():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in MAN[g]]
        assert len(names) == len(set(names)), g
        assert all(NAME.match(n) for n in names), g
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert TEXT.match(e["why"])
    for m in MAN["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entry_keys_and_sources():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve(w):
    cell = cells.Cell(w["name"])
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"] == w["traffic"]
    assert cell.workload["why"] == w["why"]
    kind = kinds.load(cell.kind)
    assert all(callable(getattr(kind, f)) for f in ("drive", "judge",
                                                     "control"))
    assert "unchanged" in kind.FAULTS
    assert 1 <= cell.threads
    e2e = [m for m in MAN["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]]
    assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
    per = [m for m in MAN["per_layer"] if w["name"] in m["workloads"]]
    assert per
    moves = {m["name"] for m in e2e}
    for m in per:
        assert m["moves"] in moves
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert all(isinstance(v, float) for v in cell.workload["limits"].values())


def test_rooflines_and_mfu_named_as_the_contract_says():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
