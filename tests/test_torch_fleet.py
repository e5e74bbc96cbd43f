"""The port's fleet merge (cst_captioning_tpu_torch.obs.fleet) and its
``cli.obs_report --postmortem <run_dir>`` against the JAX package's, on
the CPU, exact.

The committed two-process fixture (``tests/fixtures/postmortem_fleet``)
and every ``tmp_path`` case of tests/test_fleet.py (the latest bundle per
process, a single process, a missing process, a tampered bundle, an
anchor-free bundle, an injected clock offset with a straggler, the trip in
corrected time, the events tail), plus an elastic and a serving case,
merge in both packages to the same JSON and render to the same text; the
JAX tests' gates hold on the port's merge. The CLIs print the same.
"""

import json
import math
import os

import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.cli import obs_report as jax_cli
from cst_captioning_tpu.obs import fleet as jfleet
from cst_captioning_tpu.resilience import durable as jdurable
from cst_captioning_tpu_torch.cli import obs_report as cli
from cst_captioning_tpu_torch.obs import fleet as tfleet

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "postmortem_fleet")
T0 = 1.7e9


# ---- bundles as the recorder writes them (tests/test_fleet.py's helpers) -------


def _ring_row(step, ts, loss=2.0, phase="rl", anomalies=None):
    row = {"step": step, "phase": phase, "ts": ts, "loss": loss,
           "grad_norm": 1.0}
    if anomalies:
        row["anomalies"] = list(anomalies)
    return row


def _meta(proc, world, host, ring, *, reason="unit", wall0=T0,
          anchors="start", **fields):
    m = {"schema": 2, "reason": reason, "run": "synth", "proc": proc,
         "world": world, "host": host, "capacity": 64,
         "steps": [r["step"] for r in ring],
         "anchors": [[0.0, wall0]] if anchors == "start" else anchors,
         "dumped_ts": wall0 + 999.0}
    if anchors is None:
        for k in ("schema", "anchors", "proc", "world", "host"):
            del m[k]
    m.update(fields)
    return m


def _write_bundle(bdir, ring, meta, *, events=(), registry=None):
    os.makedirs(bdir)
    blobs = {
        "ring.jsonl": "".join(json.dumps(r) + "\n" for r in ring).encode(),
        "registry.json": json.dumps(
            registry or {"counters": {}, "gauges": {}, "histograms": {}}
        ).encode(),
        "events_tail.jsonl": "".join(
            json.dumps(e) + "\n" for e in events).encode(),
        "config.json": b"{}",
        "meta.json": json.dumps(meta).encode(),
    }
    for name, blob in blobs.items():
        jdurable.write_bytes_durable(os.path.join(bdir, name), blob)
    jdurable.write_manifest(bdir, blobs)
    return bdir


# ---- the cases: each writes its run dir and returns it -------------------------


def _fixture(d):
    return FIXTURE


def _latest_per_proc(d):
    ring = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 4)]
    _write_bundle(os.path.join(d, "postmortem_01_chaos_nan"), ring,
                  _meta(0, 1, "h0", ring, reason="chaos_nan"))
    _write_bundle(os.path.join(d, "postmortem_02_peer_loss"), ring,
                  _meta(0, 1, "h0", ring, reason="peer_loss"))
    return d


def _single_proc(d):
    ring = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 6)]
    _write_bundle(os.path.join(d, "postmortem_01_preempt"), ring,
                  _meta(0, 1, "solo", ring, reason="preempt", phase="rl",
                        step=5))
    return d


def _missing_proc(d):
    ring = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 4)]
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring,
                  _meta(0, 2, "h0", ring, reason="peer_loss", lost=[1]))
    return d


def _tampered(d):
    ring0 = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 6)]
    ring1 = [_ring_row(i, T0 + 3.0 + 0.1 * i) for i in range(1, 6)]
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring0,
                  _meta(0, 2, "h0", ring0, reason="peer_loss"))
    b1 = _write_bundle(
        os.path.join(d, "proc1", "postmortem_01_divergence_spike"), ring1,
        _meta(1, 2, "h1", ring1, reason="divergence_spike", wall0=T0 + 3.0))
    with open(os.path.join(b1, "ring.jsonl"), "a") as f:
        f.write('{"step": 999, "phase": "rl", "ts": 0.0, "loss": 0.0}\n')
    return d


def _legacy_anchor_free(d):
    ring0 = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 6)]
    ring1 = [_ring_row(i, T0 + 7.0 + 0.1 * i) for i in range(1, 6)]
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring0,
                  _meta(0, 2, "h0", ring0, reason="peer_loss"))
    _write_bundle(os.path.join(d, "proc1", "postmortem_01_old"), ring1,
                  _meta(1, 2, "h1", ring1, reason="old", anchors=None))
    return d


def _straggler(d):
    ring0 = [_ring_row(i, T0 + 0.1 * i) for i in range(1, 9)]
    ring1 = [_ring_row(i, T0 + 5.0 + 0.1 * i + (0.5 if i >= 6 else 0.0))
             for i in range(1, 9)]
    ring1[-1]["loss"] = math.nan
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring0,
                  _meta(0, 2, "h0", ring0, reason="peer_loss"))
    _write_bundle(
        os.path.join(d, "proc1", "postmortem_01_divergence_nonfinite"),
        ring1, _meta(1, 2, "h1", ring1, reason="divergence_nonfinite",
                     wall0=T0 + 5.0))
    return d


def _trip_in_corrected_time(d):
    ring0 = [_ring_row(i, T0 + 0.1 * i,
                       anomalies=(["loss_z"] if i == 8 else None))
             for i in range(1, 9)]
    ring1 = [_ring_row(i, T0 + 100.0 + 0.1 * i,
                       anomalies=(["grad_norm_z"] if i == 3 else None))
             for i in range(1, 9)]
    _write_bundle(os.path.join(d, "postmortem_01_divergence_spike"), ring0,
                  _meta(0, 2, "h0", ring0, reason="divergence_spike"))
    _write_bundle(
        os.path.join(d, "proc1", "postmortem_01_divergence_spike"), ring1,
        _meta(1, 2, "h1", ring1, reason="divergence_spike",
              wall0=T0 + 100.0))
    return d


def _events_tail(d):
    ring0 = [_ring_row(i, T0 + 1.0 * i) for i in range(1, 5)]
    ring1 = [_ring_row(i, T0 + 50.0 + 1.0 * i) for i in range(1, 5)]
    ev = {"event": "dcn_stall", "ts": T0 + 52.5, "op": "allreduce",
          "dur_s": 3.0}
    noise = {"event": "phase", "ts": T0 + 52.6, "name": "rl"}
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring0,
                  _meta(0, 2, "h0", ring0, reason="peer_loss"))
    _write_bundle(os.path.join(d, "proc1", "postmortem_01_peer_loss"), ring1,
                  _meta(1, 2, "h1", ring1, reason="peer_loss",
                        wall0=T0 + 50.0),
                  events=[ev, noise])
    return d


def _elastic_and_serving(d):
    """Shrink/regrow arcs (one readmitted after a refusal, one open) and a
    serving process's param-version block, late events after the rings."""
    ring0 = [_ring_row(i, T0 + 1.0 * i) for i in range(1, 6)]
    ring1 = [_ring_row(i, T0 + 1.0 * i) for i in range(1, 4)]
    events = [
        {"event": "mesh_shrink", "ts": T0 + 1.5, "victim": 1,
         "generation": 1},
        {"event": "regrow_refused", "ts": T0 + 2.5, "rejoiner": 1},
        {"event": "mesh_regrow", "ts": T0 + 3.5, "rejoiner": 1,
         "generation": 2},
        {"event": "mesh_shrink", "ts": T0 + 4.5, "victim": 2,
         "generation": 3},
        {"event": "serving_param_swap", "ts": T0 + 4.6, "version": 2,
         "prev": 1},
        {"event": "peer_loss_drain", "ts": T0 + 9.0, "phase": "rl",
         "step": 5},
    ]
    registry = {"counters": {}, "gauges": {}, "histograms": {},
                "serving": {"param_version": 2, "param_swaps": 2,
                            "swap_history": [{"from": 0, "version": 1},
                                             {"from": 1, "version": 2}]}}
    _write_bundle(os.path.join(d, "postmortem_01_peer_loss"), ring0,
                  _meta(0, 3, "h0", ring0, reason="peer_loss", lost=[2]),
                  events=events, registry=registry)
    _write_bundle(os.path.join(d, "proc1", "postmortem_01_preempt"), ring1,
                  _meta(1, 3, "h1", ring1, reason="preempt",
                        victim_host=2))
    return d


CASES = {
    "fixture": _fixture,
    "latest_per_proc": _latest_per_proc,
    "single_proc": _single_proc,
    "missing_proc": _missing_proc,
    "tampered": _tampered,
    "legacy_anchor_free": _legacy_anchor_free,
    "straggler": _straggler,
    "trip_in_corrected_time": _trip_in_corrected_time,
    "events_tail": _events_tail,
    "elastic_and_serving": _elastic_and_serving,
}


def _merged(case, tmp_path) -> dict:
    """The port's merge of one case, after holding its JSON and rendered
    text equal to the JAX package's."""
    run_dir = CASES[case](str(tmp_path))
    want = jfleet.merge_bundles(run_dir)
    got = tfleet.merge_bundles(run_dir)
    # NaN losses: compare the JSON text, where NaN equals NaN
    assert json.dumps(got, sort_keys=True, default=float) == \
        json.dumps(want, sort_keys=True, default=float)
    assert tfleet.render_fleet(got) == jfleet.render_fleet(want)
    assert tfleet.list_bundles(run_dir) == jfleet.list_bundles(run_dir)
    assert tfleet.select_latest(tfleet.discover_bundles(run_dir)) == \
        jfleet.select_latest(jfleet.discover_bundles(run_dir))
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_and_render_equal_jax(case, tmp_path):
    fleet = _merged(case, tmp_path)
    assert fleet["merged_procs"]
    assert tfleet.render_fleet(fleet).startswith("fleet postmortem: ")


def test_fixture_gates(tmp_path):
    fleet = _merged("fixture", tmp_path)
    assert fleet["merged_procs"] == [0, 1] and not fleet["degraded"]
    assert fleet["world"] == 2 and fleet["run"] == "fleetfix"
    info = {i["proc"]: i for i in fleet["procs_info"]}
    assert info[0]["offset_s"] == 0.0 and 4.0 < info[1]["offset_s"] < 6.0
    trip = fleet["trip"]
    assert (trip["proc"], trip["host"], trip["phase"], trip["step"]) == \
        (1, "host1", "rl", 7)
    assert "nonfinite" in trip["kinds"] and trip["source"] == "ring"
    assert fleet["victim_hosts"] == [1]
    text = tfleet.render_fleet(fleet)
    assert "[TRIP]" in text and "dcn_stall" in text
    assert "victim host(s): [1]" in text


def test_edge_case_gates(tmp_path):
    f = _merged("latest_per_proc", tmp_path / "a")
    assert f["procs_info"][0]["reason"] == "peer_loss"
    f = _merged("single_proc", tmp_path / "b")
    assert f["straggler"] is None and f["trip"]["source"] == "meta"
    f = _merged("missing_proc", tmp_path / "c")
    assert f["missing_procs"] == [1] and f["degraded"]
    assert "MISSING PROCS: [1]" in tfleet.render_fleet(f)
    f = _merged("tampered", tmp_path / "d")
    (ex,) = f["excluded"]
    assert ex["proc"] == 1 and any("ring.jsonl" in p for p in ex["problems"])
    f = _merged("legacy_anchor_free", tmp_path / "e")
    assert [i["skew"] for i in f["procs_info"]] == ["anchored", "unknown"]
    f = _merged("straggler", tmp_path / "f")
    assert f["procs_info"][1]["offset_s"] == pytest.approx(5.0, abs=1e-5)
    assert f["straggler"]["proc"] == 1
    assert f["straggler"]["max_lag_s"] == pytest.approx(0.5, abs=1e-5)
    assert (f["trip"]["step"], f["trip"]["kinds"]) == (8, ["nonfinite"])
    f = _merged("trip_in_corrected_time", tmp_path / "g")
    assert (f["trip"]["proc"], f["trip"]["step"]) == (1, 3)
    f = _merged("events_tail", tmp_path / "h")
    (ev,) = f["events"]
    assert ev["event"] == "dcn_stall" and ev["t_s"] == pytest.approx(1.5,
                                                                     abs=1e-4)
    f = _merged("elastic_and_serving", tmp_path / "i")
    assert [(a["host"], a["outcome"], a["refused"]) for a in f["elastic"]] \
        == [(1, "readmitted", 1), (2, "open", 0)]
    assert f["victim_hosts"] == [2]
    assert f["serving"][0]["param_version"] == 2


def test_empty_run_dir_raises_in_both(tmp_path):
    for mod in (jfleet, tfleet):
        with pytest.raises(FileNotFoundError, match="no postmortem bundles"):
            mod.merge_bundles(str(tmp_path))


# ---- the CLIs ------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["--postmortem", "RUN"], ["--postmortem", "RUN", "--json"],
    ["--postmortem", "RUN", "--list"], ["--postmortem", "BUNDLE"]],
    ids=["fleet", "fleet_json", "list", "one_bundle"])
def test_postmortem_cli_equals_jax(args, capsys):
    bundle = os.path.join(FIXTURE, "postmortem_01_peer_loss")
    argv = [FIXTURE if a == "RUN" else bundle if a == "BUNDLE" else a
            for a in args]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if args[-1] == "RUN":
        assert "procs merged: 2/2" in got and "[TRIP]" in got
    if args[-1] == "BUNDLE":
        assert "fleet postmortem" not in got


def test_postmortem_cli_errors(tmp_path, capsys):
    assert cli.main(["--postmortem", str(tmp_path / "nope")]) == 2
    assert cli.main(["--postmortem", str(tmp_path), "--list"]) == 2
    assert "no postmortem bundles" in capsys.readouterr().err
