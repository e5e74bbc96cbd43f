"""The port's observability subsystem (cst_captioning_tpu_torch.obs) against
the JAX package's, on the CPU. Tolerances are exact unless stated.

- the metrics registry: the same calls give equal snapshots and equal
  Prometheus text in both packages; ``StepMeter`` under one clock;
- the event stream: the same span script gives the same span events
  (names, depths, parents, self-time accounting) and trace tracks;
- the report: ``report_run`` / ``render_report`` of the committed fixtures
  (``tests/fixtures/obs_run``, the two-process ``postmortem_fleet`` stream)
  equal in both packages, through the CLIs' ``--json`` too, and the
  report of a port run equal in both;
- the FLOPs models give equal integers at every preset's shapes; the peak
  table holds NVIDIA datasheet figures only;
- the wiring on a tiny run: an XE + RL run with obs on in both trainers
  (the port's weights from the JAX initial params) gives the same set of
  phase rows, equal deterministic counters (``flops.*``, step counts,
  ``rl.decode.budget``, the eval funnel) and coverage >= 0.9; a serve with
  obs on gives equal ``serving.*`` counters in both engines; the
  evaluator's, prefetch's and checkpoint's spans; the step profiler's
  Chrome trace; the ``--obs`` / ``--profile`` CLIs;
- the config: the six observability knobs and the health knobs are
  accepted, every knob still unported raises naming its slice.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu import obs as jobs
from cst_captioning_tpu.cli import obs_report as jax_obs_report_cli
from cst_captioning_tpu.config.config import EOS_ID, ModelConfig
from cst_captioning_tpu.config.presets import get_preset as jax_experiment
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.synthetic import (
    make_synthetic_dataset as jax_synthetic,
)
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
)
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.obs import flops as jflops
from cst_captioning_tpu.obs import metrics as jmetrics
from cst_captioning_tpu.obs import recorder as jrecorder
from cst_captioning_tpu.obs import report as jreport
from cst_captioning_tpu.serving import CaptionService as JaxCaptionService
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import obs as tobs
from cst_captioning_tpu_torch.ckpt import CheckpointManager
from cst_captioning_tpu_torch.cli import obs_report as obs_report_cli
from cst_captioning_tpu_torch.cli.eval import main as eval_main
from cst_captioning_tpu_torch.cli.train import main as train_main
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.data import (
    CaptionDataset,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.data.prefetch import prefetch_to_device
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.obs import flops as tflops
from cst_captioning_tpu_torch.obs import metrics as tmetrics
from cst_captioning_tpu_torch.obs import recorder as trecorder
from cst_captioning_tpu_torch.obs import report as treport
from cst_captioning_tpu_torch.presets import PRESETS, get_experiment
from cst_captioning_tpu_torch.serving import CaptionService, ClipRequest
from cst_captioning_tpu_torch.train.trainer import Trainer
from cst_captioning_tpu_torch.utils.profiling import StepProfiler

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each package has its own process-global registry, span recorder
    and flight recorder (with atexit hooks): every test starts and ends
    with all of them shut and empty."""
    def reset():
        jrecorder.shutdown()
        trecorder.shutdown()
        jobs.shutdown()
        tobs.shutdown()
        jobs.REGISTRY.reset()
        tobs.REGISTRY.reset()

    reset()
    yield
    reset()


# ---- the metrics registry -----------------------------------------------------


def _drive_registry(m, script: str) -> None:
    """The same calls on either package's ``obs.metrics`` module."""
    if script == "basic":
        m.counter("a.b").inc()
        m.counter("a.b").inc(2.5)
        m.gauge("g-1").set(7)
        h = m.histogram("lat")
        for v in (0.0005, 0.003, 0.003, 0.7, 250.0):
            h.observe(v)
    elif script == "buckets":
        h = m.histogram("depth", (2.0, 4.0, 8.0))
        for v in (1, 2, 3, 9, 4):
            h.observe(v)
        m.gauge("9lives").set(-3.25)
    elif script == "specials":
        m.gauge("nan").set(float("nan"))
        m.gauge("inf").set(float("inf"))
        m.gauge("ninf").set(-float("inf"))
        m.counter("big").inc(2.0 ** 40)


@pytest.mark.parametrize("script", ["basic", "buckets", "specials"])
def test_registry_snapshot_and_prometheus_equal(script):
    _drive_registry(jmetrics, script)
    _drive_registry(tmetrics, script)
    js, ts = jmetrics.snapshot(), tmetrics.snapshot()
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert tmetrics.REGISTRY.to_prometheus() == \
        jmetrics.REGISTRY.to_prometheus()
    for name, h in js["histograms"].items():
        th = tmetrics.REGISTRY.histogram(name, h["buckets"])
        jh = jmetrics.REGISTRY.histogram(name, h["buckets"])
        for q in (0.0, 0.5, 0.95, 1.0):
            assert th.quantile(q) == jh.quantile(q)


def test_registry_kind_conflict_raises_in_both():
    for m in (jmetrics, tmetrics):
        m.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            m.gauge("x")
        with pytest.raises(ValueError, match="negative"):
            m.counter("x").inc(-1)


def test_step_meter_matches_under_one_clock(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(jmetrics.time, "perf_counter", lambda: clock["t"])
    out = []
    for m in (jmetrics, tmetrics):
        meter = m.StepMeter("xe")
        ticks = iter([0.0, 2.0, 2.5, 3.25, 3.5])
        clock["t"] = next(ticks)
        meter.begin_epoch()
        first = True
        for t in ticks:
            clock["t"] = t
            meter.tick(4, first=first)
            first = False
        out.append((meter.epoch_summary(), m.snapshot()))
    assert out[0] == out[1]
    assert out[1][1]["counters"]["xe.compile_seconds"] == 2.0


def test_record_compile_feeds_the_compile_counters():
    tmetrics.record_compile(1.5)
    tmetrics.record_compile(0.25)
    c = tmetrics.snapshot()["counters"]
    assert c == {"jit.compile_seconds": 1.75, "jit.compiles": 2.0}


def test_device_memory_gauges_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert tmetrics.observe_device_memory() is False
    assert tmetrics.snapshot()["gauges"] == {}


# ---- the event stream -----------------------------------------------------------


def _span_script(pkg, out_dir):
    # the run context is the thread's: an earlier test's trainer in this
    # worker may have left one, which run_start would carry
    pkg.set_context(phase=None, epoch=None, step=None)
    rec = pkg.configure(str(out_dir), run="script", snapshot_every=2)
    pkg.set_context(phase="xe", epoch=1)
    with pkg.span("xe.epoch"):
        for step in (1, 2):
            with pkg.span("xe.step", name="attr"):
                pkg.counter("flops.xe.step").inc(10)
            pkg.set_context(step=step)
            pkg.maybe_snapshot(step)
    w = pkg.span("profile.window", track="profiler").begin()
    pkg.event("profiler_trace_written", dir="d", steps=1)
    w.end()
    pkg.set_context(phase=None, epoch=None, step=None)
    rec.close()


_VOLATILE = ("ts", "dur", "self_dur", "pid", "thread")


def _stable(path):
    return [{k: v for k, v in e.items() if k not in _VOLATILE}
            for e in map(json.loads, open(path))]


def test_span_stream_matches_jax(tmp_path):
    _span_script(jobs, tmp_path / "jax")
    _span_script(tobs, tmp_path / "port")
    want = _stable(tmp_path / "jax" / "events.jsonl")
    got = _stable(tmp_path / "port" / "events.jsonl")
    assert got == want
    kinds = [e["event"] for e in got]
    assert kinds.count("metrics") == 2 and kinds[-1] == "run_end"
    jt = json.load(open(tmp_path / "jax" / "trace.json"))["traceEvents"]
    tt = json.load(open(tmp_path / "port" / "trace.json"))["traceEvents"]
    assert [(e["name"], e["ph"]) for e in tt] == \
        [(e["name"], e["ph"]) for e in jt]
    assert [e["tid"] == "profiler" for e in tt] == \
        [e["tid"] == "profiler" for e in jt]
    assert (tmp_path / "port" / "metrics.prom").read_text() == \
        (tmp_path / "jax" / "metrics.prom").read_text()


def test_disabled_spans_are_shared_noops():
    assert not tobs.enabled()
    assert tobs.span("a") is tobs.span("b")
    tobs.event("x")              # nothing to write to: no error
    tobs.maybe_snapshot(1)


# ---- the report ------------------------------------------------------------------


@pytest.mark.parametrize("run", ["obs_run", "postmortem_fleet"])
def test_report_of_committed_fixtures_equals_jax(run):
    path = os.path.join(FIXTURES, run)
    want = jreport.report_run(path)
    got = treport.report_run(path)
    assert json.dumps(got, sort_keys=True, default=float) == \
        json.dumps(want, sort_keys=True, default=float)
    assert treport.render_report(got) == jreport.render_report(want)
    events = jreport.load_events(path)
    assert treport.build_report(events) == jreport.build_report(events)


@pytest.mark.parametrize("args", [["RUN"], ["RUN", "--json"]],
                         ids=["text", "json"])
def test_obs_report_cli_equals_jax(args, capsys):
    argv = [os.path.join(FIXTURES, "obs_run") if a == "RUN" else a
            for a in args]
    assert jax_obs_report_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert obs_report_cli.main(argv) == 0
    assert capsys.readouterr().out == want


def test_obs_report_cli_errors(tmp_path, capsys):
    assert obs_report_cli.main([str(tmp_path)]) == 2
    assert "no events.jsonl" in capsys.readouterr().err
    # two processes' bundles merge into one fleet timeline
    # (tests/test_torch_fleet.py holds it against the JAX merge)
    fleet = os.path.join(FIXTURES, "postmortem_fleet")
    assert obs_report_cli.main(["--postmortem", fleet]) == 0
    out = capsys.readouterr().out
    assert "procs merged: 2/2" in out and "victim host(s): [1]" in out
    # --list works over every proc's bundles
    assert obs_report_cli.main(["--postmortem", fleet, "--list",
                                "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [(r["proc"], r["reason"]) for r in rows] == \
        [(0, "peer_loss"), (1, "divergence_nonfinite")]


# ---- the FLOPs models ------------------------------------------------------------


def _dims(mc):
    return dict(F=mc.max_frames, d_embed=mc.d_embed, d_hidden=mc.d_hidden,
                d_att=mc.d_att, V=mc.vocab_size,
                feat_dims=tuple(d for _, d in mc.modalities),
                num_layers=mc.num_layers)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_flops_models_equal_at_preset_shapes(preset):
    mc = PRESETS[preset]
    assert _dims(jax_experiment(preset).model) == _dims(mc)
    d = _dims(mc)
    T = mc.max_len
    args = (d["F"], d["d_embed"], d["d_hidden"], d["d_att"], d["V"],
            d["feat_dims"], d["num_layers"])
    assert tflops.enc_and_per_tok_flops(*args) == \
        jflops.enc_and_per_tok_flops(*args)
    assert tflops.xe_flops_per_row(T=T, **d) == \
        jflops.xe_flops_per_row(T=T, **d)
    for K in (1, 5):
        assert tflops.update_flops_per_clip(K=K, T=T, **d) == \
            jflops.update_flops_per_clip(K=K, T=T, **d)
        for kw in (dict(), dict(with_greedy=False), dict(fused=False),
                   dict(stride=mc.decode_stride),
                   dict(stride=3, active_frac=0.375)):
            assert tflops.decode_flops_per_clip(K=K, T=T, **d, **kw) == \
                jflops.decode_flops_per_clip(K=K, T=T, **d, **kw)
    for stride in (1, 3, mc.decode_stride):
        assert tflops.stride_steps(T, stride) == jflops.stride_steps(T, stride)
    for paged in (False, True):
        for nbytes in (2, 4):
            assert tflops.serving_bank_bytes_per_stride(
                32, 56, mc.d_embed, mc.d_att, nbytes, paged=paged) == \
                jflops.serving_bank_bytes_per_stride(
                    32, 56, mc.d_embed, mc.d_att, nbytes, paged=paged)


@pytest.mark.parametrize("name,flops,hbm", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("TPU v5 lite", 0.0, 0.0),
    ("cpu", 0.0, 0.0),
    ("NVIDIA A100-SXM4-80GB", 0.0, 0.0),
])
def test_peak_table_holds_nvidia_datasheet_peaks_only(name, flops, hbm):
    assert tflops.peak_flops(name) == flops
    assert tflops.peak_hbm(name) == hbm
    for frag, _ in tflops.PEAK_BF16_FLOPS + tflops.PEAK_HBM_BYTES:
        assert "h100" in frag
    assert not hasattr(tflops, "DEFAULT_PEAK")


def test_compiled_cost_is_the_analytic_count():
    assert tflops.compiled_cost(12.0, 5.0) == {
        "flops": 12.0, "bytes_accessed": 5.0, "backend": "analytic"}


# ---- the config and the CLIs ---------------------------------------------------


OBS_KNOBS = [("obs", True), ("obs_dir", "o"), ("recorder_steps", 8),
             ("anomaly", True), ("profile_dir", "p"), ("profile_steps", 3)]


@pytest.mark.parametrize("name,value", OBS_KNOBS,
                         ids=[n for n, _ in OBS_KNOBS])
def test_observability_knobs_are_accepted(name, value):
    cfg = get_experiment("msrvtt_cst_consensus").override(
        **{f"train__{name}": value})
    assert getattr(cfg.train, name) == value
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


# the decoupled and online RL knobs are ported (tests/test_torch_trainer.py
# holds their bad values to the JAX messages)
RL_TOPOLOGY_KNOBS = [("train", "rl_topology", "decoupled"),
                     ("rl", "rollout_depth", 3), ("rl", "staleness_bound", 0),
                     ("rl", "actor_fraction", 0.25),
                     ("rl", "online_batch_size", 8), ("rl", "swap_every", 2)]


@pytest.mark.parametrize("section,name,value", RL_TOPOLOGY_KNOBS,
                         ids=[f"{s}.{n}" for s, n, _ in RL_TOPOLOGY_KNOBS])
def test_rl_topology_knobs_are_accepted(section, name, value):
    cfg = get_experiment("msrvtt_cst_consensus").override(
        **{f"{section}__{name}": value})
    assert getattr(getattr(cfg, section), name) == value
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


# the one-device resilience knobs are ported (tests/test_torch_trainer.py
# holds their bad values to the JAX messages)
RESILIENCE_KNOBS = [
    {"train__debug_nans": True},
    # in order: each override is checked as it lands
    {"train__spike_factor": 10.0, "train__spike_mode": "adaptive"},
    {"train__spike_factor": 10.0, "train__spike_mode": "adaptive",
     "train__spike_factor_min": 2.0},
    # the health slice's knobs, and the strict elastic mode
    {"train__health": True, "train__health_dir": "hb",
     "train__health_interval_s": 0.1, "train__peer_timeout_s": 1.0,
     "train__health_misses": 3, "train__health_sim_hosts": 2,
     "train__elastic": "strict"},
    {"train__dcn_stall_s": 3.0},
]


@pytest.mark.parametrize("overrides", RESILIENCE_KNOBS,
                         ids=["debug_nans", "spike_mode", "spike_factor_min",
                              "health", "dcn_stall_s"])
def test_resilience_knobs_are_accepted(overrides):
    cfg = get_experiment("msrvtt_cst_consensus").override(**overrides)
    for key, value in overrides.items():
        section, _, name = key.partition("__")
        assert getattr(getattr(cfg, section), name) == value
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


# (section, name, value, the slice that brings it; None: ported, by the
# elastic slice)
STILL_UNPORTED = [
    ("train", "elastic", "degraded", None),
    ("train", "elastic_regrow", False, None),
    ("mesh", "seq_devices", 2, "sequence-parallel"),
    ("mesh", "mp_devices", 2, "sequence-parallel"),
    ("model", "seq_axis", "seq", "sequence-parallel"),
]


@pytest.mark.parametrize("section,name,value,slice_", STILL_UNPORTED,
                         ids=[f"{s}.{n}" for s, n, _, _ in STILL_UNPORTED])
def test_still_unported_knobs_raise_naming_their_slice(section, name, value,
                                                       slice_):
    """A knob still unported raises, naming its slice; the elastic knobs,
    ported, are accepted and round-trip through JSON as the JAX package's
    ``to_json()`` of the same override."""
    key = f"{section}__{name}"
    if slice_ is None:
        cfg = get_experiment("msrvtt_cst_consensus").override(**{key: value})
        assert getattr(getattr(cfg, section), name) == value
        want = jax_experiment("msrvtt_cst_consensus").override(
            **{key: value})
        assert json.loads(cfg.to_json()) == json.loads(want.to_json())
        assert tcfg.ExperimentConfig.from_json(want.to_json()) == cfg
        return
    with pytest.raises(ValueError, match="not ported") as e:
        get_experiment("msrvtt_cst_consensus").override(**{key: value})
    assert f"{slice_} slice" in str(e.value)


# the data-parallel knobs, ported with the data-parallel slice
# (train/mesh.py, parallel/comms.py); comm_overlap needs update_chunks >= 2
DATA_PARALLEL_KNOBS = [
    {"train__comm_bucket_mb": 8.0},
    {"train__comm_dtype": "bf16"},
    {"rl__update_chunks": 5, "train__comm_overlap": True},
    {"mesh__num_devices": 2},
]


@pytest.mark.parametrize("overrides", DATA_PARALLEL_KNOBS,
                         ids=["comm_bucket_mb", "comm_dtype", "comm_overlap",
                              "num_devices"])
def test_data_parallel_knobs_are_accepted(overrides):
    cfg = get_experiment("msrvtt_cst_consensus").override(**overrides)
    for key, value in overrides.items():
        section, _, name = key.partition("__")
        assert getattr(getattr(cfg, section), name) == value
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


def test_recorder_steps_must_be_non_negative():
    with pytest.raises(ValueError, match="recorder_steps"):
        get_experiment("msrvtt_cst_consensus").override(
            train__recorder_steps=-1)


# ---- a tiny run through both trainers ------------------------------------------

MODAL = (("resnet", 10), ("c3d", 6))
F, T, BATCH = 4, 8, 4
CORPUS = dict(num_videos=24, num_topics=3, vocab_words=20,
              modalities=dict(MODAL), max_frames=F, seed=11,
              caption_style="template", splits=(0.75, 0.125))
MODEL = dict(modalities=MODAL, d_embed=12, d_hidden=12, d_att=6,
             max_len=T, max_frames=F, dtype="float32", dropout=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_obs")
    jp = jax_synthetic(str(root / "jax"), **CORPUS)
    tp = make_synthetic_dataset(str(root / "port"), **CORPUS)
    V = len(json.load(open(jp["info_json"]))["vocab"])
    return dict(jax=jp, port=tp, V=V, root=root)


def _overrides(c, ckpt_dir, obs_dir, **extra):
    out = {f"model__{k}": v for k, v in MODEL.items()}
    out.update(model__vocab_size=c["V"], data__batch_size=BATCH,
               train__epochs=1, rl__epochs=1, rl__num_rollouts=3,
               train__log_every_steps=2, train__ckpt_dir=str(ckpt_dir),
               train__obs=True, train__obs_dir=str(obs_dir),
               train__recorder_steps=64, train__anomaly=True)
    out.update(extra)
    return out


def _datasets(c, pkg):
    files = {n: c[pkg][n] for n, _ in MODAL}
    cls = JaxDataset if pkg == "jax" else CaptionDataset
    return [cls(c[pkg]["info_json"], files, s, F) for s in ("train", "val")]


@pytest.fixture(scope="module")
def both_runs(corpus, tmp_path_factory):
    """One XE epoch and one RL epoch (greedy validation after each) with
    obs, the recorder and the detector on, in both trainers from the same
    initial params. The JAX trainer's compiled-cost probe is turned off, so
    both count the analytic model."""
    root = tmp_path_factory.mktemp("both_runs")
    mp = pytest.MonkeyPatch()
    mp.setattr(jflops, "compiled_cost", lambda *a, **k: None)
    try:
        for reg in (jobs.REGISTRY, tobs.REGISTRY):
            reg.reset()
        jcfg = jax_experiment("msrvtt_cst_consensus").override(
            **_overrides(corpus, root / "jck", root / "jobs"))
        jtr = JaxTrainer(jcfg, *_datasets(corpus, "jax"),
                         log_path=str(root / "jax.jsonl"), use_mesh=False)
        params0 = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
        jtr.train_xe()
        jtr.train_rl()
        jring = list(jrecorder.active().ring)
        jtr.close()
        jobs.shutdown()

        tcfg_ = get_experiment("msrvtt_cst_consensus").override(
            **_overrides(corpus, root / "tck", root / "tobs"))
        ttr = Trainer(tcfg_, *_datasets(corpus, "port"),
                      log_path=str(root / "port.jsonl"), device="cpu",
                      params=params0)
        ttr.train_xe()
        ttr.train_rl()
        tring = list(trecorder.active().ring)
        ttr.close()
        tobs.shutdown()
    finally:
        mp.undo()
        jrecorder.shutdown()
        trecorder.shutdown()
        jobs.shutdown()
        tobs.shutdown()
    return dict(jax=jreport.report_run(str(root / "jobs")),
                port=treport.report_run(str(root / "tobs")),
                jring=jring, tring=tring, root=root)


DETERMINISTIC = ("flops.xe.step", "flops.rl.decode", "flops.rl.update",
                 "xe.steps", "xe.clips", "rl.steps", "rl.clips",
                 "eval.batches", "eval.captions", "prefetch.batches",
                 "obs.flops.probes")


def _last_metrics(run_dir):
    return [e for e in jreport.load_events(run_dir)
            if e["event"] == "metrics"][-1]


def test_tiny_run_reports_match_jax(both_runs):
    j, t = both_runs["jax"], both_runs["port"]
    assert {p["phase"] for p in t["phases"]} == \
        {p["phase"] for p in j["phases"]}
    assert {"setup", "xe.step", "rl.decode", "rl.reward", "rl.update",
            "ckpt.save", "eval"} <= {p["phase"] for p in t["phases"]}
    assert t["coverage"] >= 0.9 and t["complete"]
    jm = _last_metrics(str(both_runs["root"] / "jobs"))
    tm = _last_metrics(str(both_runs["root"] / "tobs"))
    for name in DETERMINISTIC:
        assert tm["counters"][name] == jm["counters"][name], name
    for name in ("rl.decode.budget", "flops.backend.xe.step",
                 "flops.backend.rl.decode", "flops.backend.rl.update"):
        assert tm["gauges"][name] == jm["gauges"][name], name
    # the card's datasheet peak: none on the CPU, so no MFU
    assert tm["gauges"]["device.peak_flops"] == 0.0
    assert all(p["mfu"] is None for p in t["phases"])
    assert t["decode"]["batches"] == j["decode"]["batches"]
    assert t["decode"]["budget"] == j["decode"]["budget"]
    assert t["eval"]["batches"] == j["eval"]["batches"]


def test_tiny_run_events_render_the_same_in_both_reports(both_runs):
    run = str(both_runs["root"] / "tobs")
    assert jreport.render_report(jreport.report_run(run)) == \
        treport.render_report(treport.report_run(run))


# ---- the parts' wiring -----------------------------------------------------------


def test_checkpoint_and_prefetch_spans(corpus, tmp_path):
    cfg = get_experiment("msrvtt_cst_consensus").override(
        **_overrides(corpus, tmp_path / "ck", tmp_path / "o"))
    tr = Trainer(cfg, *_datasets(corpus, "port"), device="cpu")
    tobs.configure(str(tmp_path / "o2"), run="parts")
    mgr = CheckpointManager(str(tmp_path / "ck2"))
    mgr.save_step(tr.state, 3)
    assert mgr.restore_latest(tr.state.clone()) is not None
    staged = list(prefetch_to_device(iter([np.zeros(2), np.ones(2)]),
                                     size=1, device="cpu"))
    assert len(staged) == 2
    tr.close()
    tobs.shutdown()
    rep = treport.report_run(str(tmp_path / "o2"))
    rows = {p["phase"]: p for p in rep["phases"]}
    assert rows["ckpt.save"]["count"] == 1
    assert rows["ckpt.restore"]["count"] == 1
    over = {p["phase"]: p for p in rep["overlap"]}
    assert over["prefetch.stage"]["count"] == 2   # the worker's own track
    counters = _last_metrics(str(tmp_path / "o2"))["counters"]
    assert counters["prefetch.batches"] == 2


def test_step_profiler_writes_a_chrome_trace(tmp_path):
    tobs.configure(str(tmp_path / "o"), run="prof")
    seen = []
    prof = StepProfiler(str(tmp_path / "p"), steps=2, skip=1,
                        log=lambda ev, **f: seen.append((ev, f)))
    x = torch.ones(8)
    for _ in range(5):
        x = x * 2
        prof.tick()
    prof.stop()
    tobs.shutdown()
    trace = json.load(open(tmp_path / "p" / "trace.json"))
    assert trace["traceEvents"]
    assert seen == [("profiler_trace_written",
                     {"dir": str(tmp_path / "p"), "steps": 2})]
    rep = treport.report_run(str(tmp_path / "o"))
    assert rep["profiler_windows"] == 1
    assert [p["phase"] for p in rep["overlap"]] == ["profile.window"]


def test_disabled_profiler_is_a_noop(tmp_path):
    prof = StepProfiler("", steps=2)
    prof.tick()
    prof.stop()
    assert not os.listdir(tmp_path)


def test_train_and_eval_clis_with_obs_and_profile(corpus, tmp_path, capsys):
    common = ["--info-json", corpus["port"]["info_json"], "--device", "cpu",
              *(a for n, _ in MODAL for a in ("--feature",
                                             f"{n}={corpus['port'][n]}")),
              *(a for k, v in MODEL.items() for a in
                ("--set", f"model__{k}={v!r}")),
              "--set", f"model__vocab_size={corpus['V']}",
              "--set", f"data__batch_size={BATCH}"]
    train_main(["--preset", "msrvtt_xe_attention", *common,
                "--obs", str(tmp_path / "o"), "--profile",
                str(tmp_path / "p"), "--set", "train__epochs=1",
                "--set", "train__profile_steps=2",
                "--set", f"train__ckpt_dir='{tmp_path / 'ck'}'"])
    assert not tobs.enabled()        # the CLI shut the recorder
    rep = treport.report_run(str(tmp_path / "o"))
    assert rep["complete"] and rep["profiler_windows"] == 1
    assert os.path.exists(tmp_path / "p" / "xe" / "trace.json")
    for f in ("events.jsonl", "trace.json", "metrics.prom"):
        assert os.path.exists(tmp_path / "o" / f)
    tobs.REGISTRY.reset()      # the registry is the process's, not the run's
    eval_main(["--preset", "msrvtt_xe_attention", *common,
               "--obs", str(tmp_path / "e"), "--ckpt-dir",
               str(tmp_path / "ck"), "--split", "val",
               "--results-json", str(tmp_path / "r.json")])
    capsys.readouterr()
    erep = treport.report_run(str(tmp_path / "e"))
    assert erep["run"] == "msrvtt_xe_attention-eval-val"
    assert {"eval", "eval.pipeline.fill", "eval.pipeline.drain",
            "eval.score"} <= {p["phase"] for p in erep["phases"]}
    assert erep["eval"]["captions"] == 3


# ---- serving -------------------------------------------------------------------

SKW = dict(vocab_size=97, modalities=(("resnet", 16),), d_embed=16,
           d_hidden=16, d_att=8, encoder="temporal_attention", dropout=0.0,
           max_len=12, max_frames=8, dtype="float32", decode_impl="pallas",
           decode_stride=4)


@jax.jit
def _jax_row_noise(seed, ts):
    key = jax.random.key(seed)
    ks = jax.vmap(lambda k: jax.random.fold_in(key, k))(jnp.arange(2))

    def step(t):
        ks_t = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(ks)
        return gumbel_step_noise(ks_t, (1, 97), jnp.float32)[:, 0]

    return jax.vmap(step)(ts)


def _jax_noise(seeds, ts, K, v):
    rows = [np.asarray(_jax_row_noise(jnp.int32(s),
                                      jnp.asarray(ts[:, b], jnp.int32)))
            for b, s in enumerate(seeds.tolist())]
    return torch.from_numpy(np.stack(rows, axis=2))


def _requests(cls):
    out = []
    for i, n in enumerate((8, 7, 8, 8)):
        rng = np.random.default_rng(100 + i)
        out.append(cls(req_id=f"r{i}",
                       feats={"resnet": rng.normal(size=(n, 16))
                              .astype(np.float32)},
                       masks={"resnet": np.ones((n,), np.float32)},
                       seed=1000 + i))
    return out


def test_serve_funnel_counters_match_jax(tmp_path):
    jmodel = CaptionModel(ModelConfig(**SKW))
    rng = np.random.default_rng(0)
    params = jmodel.init(
        jax.random.key(0),
        {"resnet": jnp.asarray(rng.normal(size=(1, 8, 16)), jnp.float32)},
        {"resnet": jnp.ones((1, 8), jnp.float32)},
        jnp.zeros((1, 12), jnp.int32))
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    kw = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2,
              slo_target_s=1e-9)
    jobs.configure(str(tmp_path / "jax"), run="serve")
    jrep = JaxCaptionService(jmodel, params, **kw).serve(
        _requests(JaxClipRequest))
    jobs.shutdown()
    tmodel = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**SKW), device="cpu"),
        jax.tree.map(np.asarray, params))
    tobs.configure(str(tmp_path / "port"), run="serve")
    trep = CaptionService(tmodel, device="cpu", noise_fn=_jax_noise,
                          **kw).serve(_requests(ClipRequest))
    tobs.shutdown()
    assert trep.strides == jrep.strides
    jm = _last_metrics(str(tmp_path / "jax"))
    tm = _last_metrics(str(tmp_path / "port"))
    want = {k: v for k, v in jm["counters"].items()
            if k.startswith(("serving.", "flops.serving.", "obs.anomaly."))}
    got = {k: v for k, v in tm["counters"].items()
           if k.startswith(("serving.", "flops.serving.", "obs.anomaly."))}
    assert got == want
    assert got["serving.requests_completed"] == 4
    assert tm["histograms"]["serving.latency_seconds"]["count"] == 4
    for g in ("serving.slo.attainment.60s", "serving.slo.burn_rate.60s",
              "serving.pages.table_rows", "serving.param_version"):
        assert tm["gauges"][g] == jm["gauges"][g], g
    tr = treport.report_run(str(tmp_path / "port"))
    assert tr["serving"]["completed"] == 4 and tr["serving"]["slo"]
    assert {p["phase"] for p in tr["phases"]} >= {
        "serving.admit", "serving.encode", "serving.stride",
        "serving.detok"}


def test_stride_cost_is_analytic():
    tmodel = TorchCaptionModel(tcfg.ModelConfig(**SKW), device="cpu")
    svc = CaptionService(tmodel, capacity=2, num_rollouts=2, stride=4,
                         device="cpu")
    assert svc.stride_cost() is None
    svc.serve(_requests(ClipRequest)[:1])
    cost = svc.stride_cost()
    assert cost["backend"] == "analytic"
    assert cost["flops"] == 2 * 3 * 4 * svc._tok_flops
    assert cost["bytes_accessed"] == tflops.serving_bank_bytes_per_stride(
        2, svc.table_width * svc.bank.page_size, 16, 8, 4, paged=True)
    assert math.isfinite(cost["flops"]) and cost["flops"] > 0


def test_tiny_run_update_ratios_match_jax(both_runs):
    """The XE steps' flight-recorder records: the same steps, losses and
    grad norms, and per-family update ratios within 1e-5 relative (the
    RL steps' rollouts come from each package's own noise, so only their
    keys are compared)."""
    jxe = [r for r in both_runs["jring"] if r["phase"] == "xe"]
    txe = [r for r in both_runs["tring"] if r["phase"] == "xe"]
    assert [r["step"] for r in txe] == [r["step"] for r in jxe]
    assert len(txe) > 2
    for j, t in zip(jxe, txe):
        ratios = [k for k in j if k.startswith("upd_ratio/")]
        assert sorted(ratios) == sorted(k for k in t
                                        if k.startswith("upd_ratio/"))
        assert len(ratios) == 5     # encoder, cell, init_c0, init_h0, global
        for k in ratios + ["loss", "grad_norm"]:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
        assert t["anomalies"] == j["anomalies"] == []
    jrl = [r for r in both_runs["jring"] if r["phase"] == "rl"]
    trl = [r for r in both_runs["tring"] if r["phase"] == "rl"]
    assert [r["step"] for r in trl] == [r["step"] for r in jrl]
    want = set(jrl[0]) - {"probe"}
    assert want <= set(trl[0])
    assert all(math.isfinite(r["sample_entropy"]) for r in trl)
