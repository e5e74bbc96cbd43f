"""The port's flight recorder and anomaly detection (obs/recorder.py,
obs/anomaly.py) against the JAX package's, on the CPU. Exact unless
stated.

- the detectors: streams drawn with numpy from a seed (level, noise,
  spikes, non-finite values, step gaps) give the same verdicts, the same
  ``obs.anomaly.<kind>`` counters and the same ``anomaly`` events;
- the ring: tensor and float scalars buffered zero-sync, one readback a
  flush (``readbacks``), the same ring records and verdicts as the JAX
  recorder on the same scalars;
- bundles across packages: the committed ``tests/fixtures/postmortem_bundle``
  and a JAX-written bundle read and verified by the port, a port-written
  bundle read and verified by JAX's ``load_postmortem``, each rendered the
  same by both; a tampered bundle fails; the dump budget;
- the divergence sentinel: the same verdict spelling and counters, a
  postmortem before the policy acts;
- the trainer: parameters and losses bitwise equal with obs and the
  recorder on or off (XE and RL); a SIGTERM save and a serving drain dump
  verified bundles.
"""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu import obs as jobs
from cst_captioning_tpu.obs import anomaly as janomaly
from cst_captioning_tpu.obs import recorder as jrecorder
from cst_captioning_tpu.obs import report as jreport
from cst_captioning_tpu.resilience.sentinel import (
    DivergenceSentinel as JaxSentinel,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import obs as tobs
from cst_captioning_tpu_torch.data import (
    CaptionDataset,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.obs import anomaly as tanomaly
from cst_captioning_tpu_torch.obs import recorder as trecorder
from cst_captioning_tpu_torch.obs import report as treport
from cst_captioning_tpu_torch.presets import get_experiment
from cst_captioning_tpu_torch.resilience.preempt import Preempted
from cst_captioning_tpu_torch.resilience.sentinel import DivergenceSentinel
from cst_captioning_tpu_torch.serving import CaptionService, ClipRequest
from cst_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BUNDLE = os.path.join(os.path.dirname(__file__), "fixtures",
                      "postmortem_bundle")


@pytest.fixture(autouse=True)
def _clean_obs():
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


def _counters(m):
    return m.snapshot()["counters"]


# ---- the detectors ------------------------------------------------------------


def _stream(seed: int, n: int = 120):
    """A numpy-drawn stream: a level with noise, a few spikes, a level
    shift, and non-finite values at seeded places."""
    rng = np.random.default_rng(seed)
    x = 2.0 + 0.05 * rng.standard_normal(n)
    x[rng.choice(np.arange(20, n), 3, replace=False)] += 3.0
    x[n // 2:] += 0.5
    bad = rng.choice(np.arange(10, n), 2, replace=False)
    x[bad[0]] = np.nan
    x[bad[1]] = np.inf
    return [float(v) for v in x]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("stream", ["loss", "grad_norm", "reward",
                                    "step_time", "unjudged"])
def test_detector_verdicts_match_jax(seed, stream, tmp_path):
    jobs.configure(str(tmp_path / "jax"), run="det")
    tobs.configure(str(tmp_path / "port"), run="det")
    jd, td = janomaly.AnomalyDetector(), tanomaly.AnomalyDetector()
    xs = _stream(seed)
    jv = [jd.observe(stream, x, step=i, phase="xe") for i, x in enumerate(xs)]
    tv = [td.observe(stream, x, step=i, phase="xe") for i, x in enumerate(xs)]
    assert tv == jv
    if stream != "unjudged":
        assert sum(map(len, tv)) >= 3      # the spikes and the non-finites
    assert _counters(tobs) == _counters(jobs)
    jobs.shutdown()
    tobs.shutdown()
    keep = ("event", "kind", "stream", "step", "phase", "value", "z")

    def anomalies(path):
        return [{k: e[k] for k in keep if k in e}
                for e in map(json.loads, open(path))
                if e["event"] == "anomaly"]

    assert json.dumps(anomalies(tmp_path / "port" / "events.jsonl")) == \
        json.dumps(anomalies(tmp_path / "jax" / "events.jsonl"))


@pytest.mark.parametrize("seed", [3, 4])
def test_stall_detector_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gaps = list(0.1 + 0.01 * rng.random(40))
    gaps[rng.integers(10, 40)] = 5.0
    jd, td = janomaly.AnomalyDetector(), tanomaly.AnomalyDetector()
    jv = [jd.observe_gap(g, step=i) for i, g in enumerate(gaps)]
    tv = [td.observe_gap(g, step=i) for i, g in enumerate(gaps)]
    assert tv == jv and ["stall"] in tv
    assert _counters(tobs) == _counters(jobs)


def test_ewma_matches_jax():
    rng = np.random.default_rng(5)
    je, te = janomaly.Ewma(alpha=0.2, warmup=4), tanomaly.Ewma(alpha=0.2,
                                                                warmup=4)
    for x in rng.standard_normal(50):
        assert te.update(float(x)) == je.update(float(x))
    assert (te.mean, te.var, te.n) == (je.mean, je.var, je.n)
    with pytest.raises(ValueError):
        tanomaly.Ewma(alpha=0.0)


# ---- the ring ------------------------------------------------------------------


def test_ring_flush_is_one_readback_and_matches_jax(tmp_path, monkeypatch):
    t = {"now": 100.0}
    monkeypatch.setattr(trecorder.time, "perf_counter", lambda: t["now"])
    frs = []
    for mod, det in ((jrecorder, janomaly), (trecorder, tanomaly)):
        fr = mod.FlightRecorder(8, str(tmp_path / mod.__name__),
                                detector=det.AnomalyDetector())
        rng = np.random.default_rng(7)
        for step in range(1, 21):
            t["now"] += 0.5
            loss = np.float32(2.0 + 0.1 * rng.standard_normal())
            if step == 17:
                loss = np.float32(np.nan)
            # the same values in each package's device scalar type
            val = (torch.tensor(loss) if mod is trecorder
                   else jobs_array(loss))
            fr.record(step, "xe", {"loss": val, "grad_norm": 0.5})
        fr.flush()
        frs.append(fr)
    jr, tr = frs
    assert tr.readbacks == 1          # 20 steps buffered, one readback
    def strip(ring):
        return json.dumps([{k: v for k, v in r.items() if k != "ts"}
                           for r in ring], sort_keys=True)

    assert strip(tr.ring) == strip(jr.ring)
    assert len(tr.ring) == 8 and tr.ring[-1]["step"] == 20
    assert "nonfinite" in tr.ring[-4]["anomalies"]
    for fr in frs:
        fr.close()


def jobs_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_host_floats_need_no_readback(tmp_path):
    fr = trecorder.FlightRecorder(4, str(tmp_path))
    for step in range(1, 6):
        fr.record(step, "xe", {"loss": 1.0 / step, "grad_norm": 0.5})
    fr.flush()
    assert fr.readbacks == 0 and len(fr.ring) == 4
    fr.flush()                       # nothing buffered: nothing read
    fr.record(6, "xe", {"loss": torch.tensor(0.5)})
    fr.flush()
    assert fr.readbacks == 1 and fr.ring[-1]["loss"] == 0.5
    fr.close()


def test_module_api_is_a_noop_when_unconfigured():
    trecorder.record(1, "xe", {"loss": torch.tensor(1.0)})
    trecorder.flush()
    assert trecorder.postmortem("x") is None
    assert trecorder.active() is None


# ---- bundles across packages ---------------------------------------------------


def _equal_renders(bundle):
    jpm, tpm = jreport.load_postmortem(bundle), treport.load_postmortem(bundle)
    assert tpm == jpm
    assert treport.render_postmortem(tpm) == jreport.render_postmortem(jpm)
    return tpm


def test_fixture_bundle_verifies_in_the_port():
    pm = _equal_renders(BUNDLE)
    assert pm["verified"] and pm["meta"]["reason"] == "divergence_nonfinite"
    assert [r["step"] for r in pm["ring"]] == pm["meta"]["steps"]


def _dump(mod, det_mod, root, tensor):
    tobs.configure(str(root / "events"), run="bundle")
    fr = mod.configure(6, str(root), run="bundle",
                       detector=det_mod.AnomalyDetector(),
                       config={"train": {"recorder_steps": 6}})
    rng = np.random.default_rng(3)
    for step in range(1, 10):
        fr.record(step, "rl", {"rl_loss": tensor(np.float32(
            rng.standard_normal())), "reward_mean": 0.25})
    path = mod.postmortem("divergence_nonfinite", phase="rl", step=9,
                          loss=float("nan"), action="skip_batch")
    mod.shutdown()
    tobs.shutdown()
    return path


def test_port_bundle_reads_in_jax_and_back(tmp_path):
    path = _dump(trecorder, tanomaly, tmp_path / "port", torch.tensor)
    assert os.path.basename(path) == "postmortem_01_divergence_nonfinite"
    pm = _equal_renders(path)
    assert pm["verified"] and pm["meta"]["schema"] == 2
    assert pm["meta"]["steps"] == [4, 5, 6, 7, 8, 9]
    assert pm["events_tail_lines"] > 0
    assert pm["registry"]["gauges"]["obs.recorder.dump_budget"] == 3.0
    jpath = _dump(jrecorder, janomaly, tmp_path / "jax", jobs_array)
    jpm = _equal_renders(jpath)
    assert jpm["verified"] and jpm["meta"]["steps"] == pm["meta"]["steps"]
    assert [r["rl_loss"] for r in jpm["ring"]] == \
        [r["rl_loss"] for r in pm["ring"]]


def test_tampered_bundle_fails_verification(tmp_path):
    path = _dump(trecorder, tanomaly, tmp_path, torch.tensor)
    ring = os.path.join(path, "ring.jsonl")
    text = open(ring).read()
    with open(ring, "w") as f:
        f.write(text.replace('"step": 4', '"step": 5', 1))
    pm = treport.load_postmortem(path)
    assert not pm["verified"] and "ring.jsonl" in pm["problems"][0]
    assert "NOT verified" in treport.render_postmortem(pm)


def test_dump_budget_matches_jax(tmp_path):
    out = []
    for mod in (jrecorder, trecorder):
        fr = mod.FlightRecorder(2, str(tmp_path / mod.__name__),
                                max_dumps=2)
        out.append([fr.postmortem("trip") is not None for _ in range(3)])
        fr.close()
    assert out[0] == out[1] == [True, True, False]


def test_postmortem_cli_renders_a_port_bundle(tmp_path, capsys):
    from cst_captioning_tpu_torch.cli import obs_report

    path = _dump(trecorder, tanomaly, tmp_path, torch.tensor)
    assert obs_report.main(["--postmortem", path]) == 0
    assert "manifest verified (sha256)" in capsys.readouterr().out
    # a run dir: its latest bundle
    assert obs_report.main(["--postmortem", str(tmp_path)]) == 0
    assert "divergence_nonfinite" in capsys.readouterr().out


# ---- the divergence sentinel -----------------------------------------------------


@pytest.mark.parametrize("policy", ["skip_batch", "rollback", "abort"])
def test_sentinel_verdicts_match_jax(policy, tmp_path):
    out = []
    for pkg, rec_mod, cls in ((jobs, jrecorder, JaxSentinel),
                              (tobs, trecorder, DivergenceSentinel)):
        pkg.configure(str(tmp_path / pkg.__name__), run="sentinel")
        rec_mod.configure(8, str(tmp_path / pkg.__name__))
        s = cls(policy=policy, spike_factor=3.0, warmup=2)
        for step, loss in enumerate([1.0, 1.1, 1.0, 9.0, float("nan")], 1):
            s.push(step, np.float32(loss), 0.0)
        try:
            s.flush()
            raised = None
        except Exception as e:  # noqa: BLE001 - the policy's escape
            raised = type(e).__name__
        out.append((raised, _counters(pkg),
                    sorted(os.listdir(tmp_path / pkg.__name__))))
        rec_mod.shutdown()
        pkg.shutdown()
    assert out[1] == out[0]
    assert any(n.startswith("postmortem_01_divergence_") for n in out[1][2])


# ---- the trainer and the engine ----------------------------------------------------

MODAL = (("resnet", 10), ("c3d", 6))
F, T = 4, 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recorder")
    paths = make_synthetic_dataset(
        str(root / "d"), num_videos=24, num_topics=3, vocab_words=20,
        modalities=dict(MODAL), max_frames=F, seed=11,
        caption_style="template", splits=(0.75, 0.125))
    return dict(paths=paths, V=len(json.load(open(paths["info_json"]))
                                   ["vocab"]))


def _cfg(c, root, **extra):
    kw = dict(model__modalities=MODAL, model__d_embed=12, model__d_hidden=12,
              model__d_att=6, model__max_len=T, model__max_frames=F,
              model__dtype="float32", model__vocab_size=c["V"],
              data__batch_size=4, train__epochs=1, rl__epochs=1,
              rl__num_rollouts=3, train__log_every_steps=2,
              train__ckpt_dir=str(root / "ck"))
    kw.update(extra)
    return get_experiment("msrvtt_cst_consensus").override(**kw)


def _trainer(c, cfg):
    ds = [CaptionDataset(c["paths"]["info_json"],
                         {n: c["paths"][n] for n, _ in MODAL}, s, F)
          for s in ("train", "val")]
    return Trainer(cfg, *ds, device="cpu",
                   log_path=os.path.join(cfg.train.ckpt_dir, "log.jsonl"))


def _losses(cfg):
    path = os.path.join(cfg.train.ckpt_dir, "log.jsonl")
    return [(e["event"], e.get("loss", e.get("rl_loss")))
            for e in map(json.loads, open(path))
            if e["event"] in ("xe_step", "rl_step")]


def test_params_and_losses_bitwise_with_obs_on_or_off(corpus, tmp_path):
    runs = []
    for on in (False, True):
        extra = dict(train__log_every_steps=1)
        if on:
            extra.update(train__obs=True, train__recorder_steps=16,
                         train__anomaly=True)
        cfg = _cfg(corpus, tmp_path / str(on), **extra)
        tr = _trainer(corpus, cfg)
        tr.train_xe()
        tr.train_rl()
        if on:
            ring = list(trecorder.active().ring)
            assert ring and all(math.isfinite(r["upd_ratio/global"])
                                for r in ring)
        tr.close()
        tobs.shutdown()
        runs.append((tr, _losses(cfg)))
    (off, off_l), (on, on_l) = runs
    assert on_l == off_l and len(on_l) > 4
    for a, b in zip(off.model.parameters(), on.model.parameters()):
        assert torch.equal(a, b)


def test_sigterm_save_dumps_a_postmortem(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path, train__obs=True, train__recorder_steps=8)
    tr = _trainer(corpus, cfg)
    step = tr.xe_step

    def xe_step(*a):
        out = step(*a)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.xe_step = xe_step
    with pytest.raises(Preempted):
        tr.train_xe()
    tr.close()
    obs_dir = tmp_path / "ck" / "obs"
    bundles = [n for n in os.listdir(obs_dir) if n.startswith("postmortem")]
    assert bundles == ["postmortem_01_preempt"]
    pm = jreport.load_postmortem(str(obs_dir / bundles[0]))
    assert pm["verified"] and [r["step"] for r in pm["ring"]] == [1, 2]
    assert pm["meta"]["phase"] == "xe" and pm["meta"]["step"] == 2


def test_serving_drain_dumps_a_verified_postmortem(tmp_path):
    cfg = tcfg.ModelConfig(
        vocab_size=50, modalities=(("resnet", 16),), d_embed=16,
        d_hidden=16, d_att=8, dropout=0.0, max_len=12, max_frames=8,
        dtype="float32", decode_impl="pallas", decode_stride=4)
    svc = CaptionService(CaptionModel(cfg, device="cpu"), capacity=2,
                         num_rollouts=2, stride=4, device="cpu",
                         slo_target_s=1.0)
    reqs = []
    for i in range(5):
        rng = np.random.default_rng(i)
        reqs.append(ClipRequest(
            req_id=f"r{i}", seed=i,
            feats={"resnet": rng.normal(size=(8, 16)).astype(np.float32)},
            masks={"resnet": np.ones((8,), np.float32)}))
    tobs.configure(str(tmp_path / "obs"), run="serve")
    svc._feedback = lambda req, res, v: svc.drain("test")
    rep = svc.serve(reqs, snapshot_dir=str(tmp_path / "snap"))
    tobs.shutdown()
    assert rep.drained and rep.drain_reason == "test"
    found = [n for n in os.listdir(tmp_path / "obs")
             if n.startswith("postmortem")]
    assert found == ["postmortem_01_serving_drain_test"]
    pm = jreport.load_postmortem(str(tmp_path / "obs" / found[0]))
    assert pm["verified"]
    assert pm["registry"]["serving"]["drain_reason"] == "test"
    assert pm["registry"]["serving"]["slo"]["target_s"] == 1.0
    counters = pm["registry"]["counters"]
    assert counters["serving.drains"] == 1.0
    assert counters["serving.requests_submitted"] == 5.0
