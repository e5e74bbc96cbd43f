"""Chaos plans through the port's Trainer, SCST, decoupled RL and serving
engine on the CPU: the one-device cases of tests/test_chaos_train.py, held
to that file's gates, and the port's ``debug_nans`` and adaptive sentinel.

- SIGTERM mid-epoch -> mid-epoch save -> resume, bitwise equal (params and
  per-step losses) to the uninterrupted run, XE and RL;
- a NaN-poisoned batch under ``skip_batch``: the epoch completes, the step
  counter leaves it out, the params after it are bitwise those before it;
  ``abort`` raises, ``rollback`` restores and salts the order;
- transient reward failures retried (``reward_retry``), ENOSPC at a
  step-interval save reclaims the oldest generation;
- a decoupled RL preempt persists the ring and resumes bitwise, and an
  ``actor_preempt`` falls back to the sync schedule;
- a drain landing at the hot swap refuses it, and the replay of the drained
  queue is bitwise equal to a run without the fault;
- every one-device chaos point fires under a plan;
- peer loss under ``elastic="strict"`` (``train.health`` with two
  simulated hosts): a ``partial_preempt`` at ``xe.step`` drains, saves a
  verifiable step checkpoint, dumps a ``peer_loss`` postmortem naming the
  lost host (merged with a victim's bundle by ``obs.fleet``) and raises
  ``PeerLost``; at ``rl.step`` (sequential and pipelined, the seam saved)
  the drain stops at batch 1 and a full restart from a fresh health
  directory ends bitwise equal to the straight run; the drain events'
  ``phase``, ``step``, ``batch_index`` and ``lost`` equal the JAX
  trainer's (``use_mesh=False``) on the same corpus and config; a peer
  that stops beating is found by the trainer's watchdog by staleness and
  the epoch drains.
"""

import dataclasses
import json
import math
import os
import signal
import time

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from cst_captioning_tpu.data import CaptionDataset as JaxDataset
from cst_captioning_tpu.data import (
    make_synthetic_dataset as jax_synthetic,
)
from cst_captioning_tpu.resilience import Fault as JaxFault
from cst_captioning_tpu.resilience import FaultPlan as JaxFaultPlan
from cst_captioning_tpu.resilience import PeerLost as JaxPeerLost
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import (
    DataConfig,
    EOS_ID,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    RLConfig,
    TrainConfig,
)
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.data import CaptionDataset, make_synthetic_dataset
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.obs import fleet
from cst_captioning_tpu_torch.obs import recorder
from cst_captioning_tpu_torch.resilience import (
    Fault,
    FaultPlan,
    HealthMonitor,
    PeerLost,
    Preempted,
    TrainingDiverged,
    verify_manifest,
)
from cst_captioning_tpu_torch.resilience.adaptive import AdaptiveThresholds
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    load_snapshot,
)
from cst_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# the JAX chaos tests' corpus: 10 train videos x seq_per_vid 2 = 20 rows,
# 3 XE batches of 8 an epoch; 2 RL batches of 8
STEPS_PER_EPOCH = 3


CORPUS = dict(num_videos=12, num_topics=3, vocab_words=20,
              modalities={"resnet": 16}, max_frames=4, seed=5)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaossynth")
    paths = make_synthetic_dataset(str(out), **CORPUS)
    return tuple(CaptionDataset(paths["info_json"],
                                {"resnet": paths["resnet"]}, split, 4)
                 for split in ("train", "val"))


@pytest.fixture(scope="module")
def jax_train_ds(tmp_path_factory):
    """The same corpus in the JAX package's files (equal by
    test_torch_data.py), for the JAX trainer."""
    out = tmp_path_factory.mktemp("jaxchaossynth")
    paths = jax_synthetic(str(out), **CORPUS)
    return JaxDataset(paths["info_json"], {"resnet": paths["resnet"]},
                      "train", 4)


def make_cfg(ckpt_dir, vocab_size: int, *, pipelined: bool = False,
             batch_size: int = 8, seq_per_vid: int = 2, rl_epochs: int = 2,
             rl_topology: str = "sync", **train_kw) -> ExperimentConfig:
    train_kw.setdefault("eval_every_epochs", 100)
    train_kw.setdefault("epochs", 2)
    return ExperimentConfig(
        name="chaos",
        model=ModelConfig(vocab_size=vocab_size, modalities=(("resnet", 16),),
                          d_embed=16, d_hidden=16, d_att=8,
                          encoder="temporal_attention", dropout=0.0,
                          max_len=8, max_frames=4, dtype="float32"),
        data=DataConfig(batch_size=batch_size, seq_per_vid=seq_per_vid),
        train=TrainConfig(lr=5e-3, grad_clip=5.0, ckpt_dir=str(ckpt_dir),
                          seed=0, log_every_steps=1, rl_topology=rl_topology,
                          **train_kw),
        rl=RLConfig(enabled=True, num_rollouts=2, lr=1e-3, epochs=rl_epochs,
                    baseline="greedy", pipelined=pipelined),
        eval=EvalConfig(beam_size=1, max_len=8))


def trainer(cfg, ds, val=None, log=None):
    return Trainer(cfg, ds, val, log_path=str(log) if log else "",
                   device="cpu")


def events_of(path, kind):
    return [e for e in map(json.loads, open(path)) if e["event"] == kind]


def params_equal(a, b):
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def resumed(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume="auto"))


@pytest.fixture(scope="module")
def straight_xe(datasets, tmp_path_factory):
    d = tmp_path_factory.mktemp("straight")
    train_ds, _ = datasets
    tr = trainer(make_cfg(d, len(train_ds.vocab)), train_ds, log=d / "ev")
    tr.train_xe()
    tr.close()
    return tr, d / "ev"


def test_sigterm_mid_epoch_resume_is_bit_identical(datasets, straight_xe,
                                                   tmp_path):
    train_ds, _ = datasets
    ref, ref_log = straight_xe
    cfg = make_cfg(tmp_path, len(train_ds.vocab))
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    assert tr.steps_per_epoch == STEPS_PER_EPOCH
    prev = signal.getsignal(signal.SIGTERM)
    plan = FaultPlan([Fault("xe.step", "preempt", at=STEPS_PER_EPOCH + 1)])
    with plan.activate():
        with pytest.raises(Preempted):
            tr.train_xe()
    tr.close()
    # the signal landed under the trainer's handler, which is gone again
    assert signal.getsignal(signal.SIGTERM) == prev
    assert plan.fired[0]["kind"] == "preempt"
    assert events_of(tmp_path / "ev", "preempt")[0]["batch_index"] == 2
    (step_dir,) = [n for n in os.listdir(tmp_path) if n.startswith("step_")]
    infos = json.load(open(tmp_path / step_dir / "infos.json"))
    assert infos["phase"] == "xe" and infos["batch_index"] == 2
    assert infos["xe_epochs"] == 1

    again = trainer(resumed(cfg), train_ds, log=tmp_path / "ev2")
    assert again._resume_batch == 2
    again.train_xe()
    again.close()
    assert again.xe_epochs == ref.xe_epochs == 2
    assert again.state.step == ref.state.step
    params_equal(again.state, ref.state)
    want = {e["step"]: e["loss"] for e in events_of(ref_log, "xe_step")}
    got = {e["step"]: e["loss"] for e in events_of(tmp_path / "ev",
                                                   "xe_step")}
    got.update({e["step"]: e["loss"]
                for e in events_of(tmp_path / "ev2", "xe_step")})
    assert got == want


class StepTap:
    """Wraps a trainer's XE step: the params before and after each."""

    def __init__(self, tr):
        self.real, self.steps = tr.xe_step, []
        tr.xe_step = self

    def __call__(self, state, *args):
        before = [p.detach().clone() for p in state.params]
        state, m = self.real(state, *args)
        self.steps.append((before, [p.detach().clone() for p in state.params],
                           float(m.get("nonfinite", 0.0))))
        return state, m


def test_nan_batch_skipped_epoch_completes(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=1)
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    tap = StepTap(tr)
    plan = FaultPlan([Fault("xe.batch", "nan", at=1)])
    with plan.activate():
        tr.train_xe()
    tr.close()
    assert tr.xe_epochs == 1 and plan.fired[0]["kind"] == "nan"
    assert tr.state.step == STEPS_PER_EPOCH - 1
    assert [s[2] for s in tap.steps] == [0.0, 1.0, 0.0]
    before, after, _ = tap.steps[1]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    for p in tr.state.params:
        assert torch.isfinite(p).all()
    (div,) = events_of(tmp_path / "ev", "divergence")
    assert div["kind"] == "nonfinite" and div["action"] == "skip_batch"
    (ep,) = events_of(tmp_path / "ev", "xe_epoch")
    assert np.isfinite(ep["loss"])


def test_nan_batch_abort_policy_raises(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=1,
                   on_divergence="abort")
    tr = trainer(cfg, train_ds)
    with FaultPlan([Fault("xe.batch", "nan", at=1)]).activate():
        with pytest.raises(TrainingDiverged):
            tr.train_xe()
    tr.close()


def test_nan_batch_rollback_restores_and_resalts(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), on_divergence="rollback")
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    with FaultPlan([Fault("xe.batch", "nan",
                          at=STEPS_PER_EPOCH + 1)]).activate():
        tr.train_xe()
    tr.close()
    assert tr.xe_epochs == 2 and tr.epoch == 2 and tr.batcher.salt == 1
    (rb,) = events_of(tmp_path / "ev", "rollback")
    assert rb["restored_epoch"] == 1 and rb["salt"] == 1
    for p in tr.state.params:
        assert torch.isfinite(p).all()


def test_debug_nans_names_the_module_and_leaves_params_bitwise(
        datasets, straight_xe, tmp_path):
    train_ds, _ = datasets
    ref, _ = straight_xe
    assert not torch.is_anomaly_enabled()
    cfg = make_cfg(tmp_path / "on", len(train_ds.vocab), debug_nans=True)
    tr = trainer(cfg, train_ds)
    assert torch.is_anomaly_enabled()
    tr.train_xe()
    tr.close()
    assert not torch.is_anomaly_enabled() and tr._nan_hooks is None
    params_equal(tr.state, ref.state)
    # the poisoned batch raises at the first module it reaches
    tr = trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=str(tmp_path / "nan"))), train_ds)
    try:
        with FaultPlan([Fault("xe.batch", "nan", at=1)]).activate():
            with pytest.raises(FloatingPointError,
                               match=r"module 'encoder\.") as e:
                tr.train_xe()
    finally:
        tr.close()
    assert "not finite" in str(e.value)
    assert tr.state.step == 1
    assert not torch.is_anomaly_enabled()
    # a module after close() runs without the hooks
    feats = {"resnet": torch.full((1, 4, 16), float("nan"))}
    tr.model.encode(feats, {"resnet": torch.ones(1, 4)})


def test_adaptive_sentinel_shares_the_detectors_ewma(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=1, spike_factor=10.0,
                   spike_mode="adaptive", spike_factor_min=2.0)
    tr = trainer(cfg, train_ds)
    s = tr._make_sentinel("xe")
    assert isinstance(s.adaptive, AdaptiveThresholds)
    assert (s.adaptive.factor_max, s.adaptive.factor_min) == (10.0, 2.0)
    assert not s.adaptive._shared
    tr._detector = type("D", (), {"ewma": lambda self, n: "loss-ewma"})()
    assert tr._make_sentinel("xe").adaptive.ewma == "loss-ewma"
    tr.close()
    fixed = trainer(make_cfg(tmp_path / "f", len(train_ds.vocab),
                             spike_factor=10.0), train_ds)
    assert fixed._make_sentinel("xe").adaptive is None
    fixed.close()


def test_enospc_during_training_rotation_recovers(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), ckpt_every_steps=2,
                   keep_ckpts=2)
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    with FaultPlan([Fault("ckpt.save", "enospc_rotation", at=2)]).activate():
        tr.train_xe()
    tr.close()
    assert tr.xe_epochs == 2
    (ev,) = events_of(tmp_path / "ev", "ckpt_enospc")
    assert ev["freed"] == ["step_00000002"]
    assert [s for s, _ in tr.ckpt.step_checkpoints()] == [4, 6]


def _rl_run(datasets, ckpt_dir, resume="", **kw):
    train_ds, _ = datasets
    kw.setdefault("epochs", 1)
    cfg = make_cfg(ckpt_dir, len(train_ds.vocab), resume=resume, **kw)
    tr = trainer(cfg, train_ds, log=os.path.join(ckpt_dir, "ev"))
    try:
        tr.train_xe()
        tr.train_rl()
    finally:
        tr.close()
    return tr


def test_rl_preemption_strict_resume_is_bit_identical(datasets, tmp_path):
    straight = _rl_run(datasets, tmp_path / "a")
    with FaultPlan([Fault("rl.step", "preempt", at=2)]).activate():
        with pytest.raises(Preempted):
            _rl_run(datasets, tmp_path / "b")
    saves = events_of(tmp_path / "b" / "ev", "ckpt_step")
    assert saves[-1]["phase"] == "rl" and saves[-1]["batch_index"] == 1
    again = _rl_run(datasets, tmp_path / "b", resume="auto")
    assert again.rl_epochs == straight.rl_epochs == 2
    assert again.state.step == straight.state.step
    params_equal(again.state, straight.state)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
def test_transient_reward_failures_are_retried(datasets, tmp_path,
                                               pipelined):
    """The pipelined loop scores on its worker thread: the fault fires
    there and the retry runs there."""
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=1, rl_epochs=1,
                   pipelined=pipelined)
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    tr.train_xe()
    plan = FaultPlan([Fault("reward.call", "io_error", at=0)])
    with plan.activate():
        tr.train_rl()
    tr.close()
    assert tr.rl_epochs == 1 and plan.visits("reward.call") == 5
    (retry,) = events_of(tmp_path / "ev", "reward_retry")
    assert retry["error"] == "TransientIOError" and retry["attempt"] == 1


def test_a_kill_at_the_reward_thread_reaches_the_trainer(datasets, tmp_path):
    train_ds, _ = datasets
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=1, rl_epochs=1,
                   pipelined=True)
    tr = trainer(cfg, train_ds)
    tr.train_xe()
    with FaultPlan([Fault("reward.call", "kill", at=0)]).activate():
        with pytest.raises(BaseException) as e:
            tr.train_rl()
    tr.close()
    assert type(e.value).__name__ == "SimulatedKill"


def test_decoupled_preempt_ring_seam_resume_is_bit_identical(datasets,
                                                             tmp_path):
    kw = dict(pipelined=True, batch_size=2, seq_per_vid=1,
              rl_topology="decoupled")
    straight = _rl_run(datasets, tmp_path / "a", **kw)
    with FaultPlan([Fault("rl.step", "preempt", at=6)]).activate():
        with pytest.raises(Preempted):
            _rl_run(datasets, tmp_path / "b", **kw)
    saves = events_of(tmp_path / "b" / "ev", "ckpt_step")
    assert saves[-1]["phase"] == "rl" and saves[-1]["seam"] is True
    assert 0 < saves[-1]["batch_index"] < 5
    again = _rl_run(datasets, tmp_path / "b", resume="auto", **kw)
    assert events_of(tmp_path / "b" / "ev", "seam_loaded")
    assert again.rl_epochs == straight.rl_epochs == 2
    params_equal(again.state, straight.state)


def test_decoupled_actor_preempt_falls_back_to_sync(datasets, tmp_path):
    tr = None
    plan = FaultPlan([Fault("rl.actor.step", "actor_preempt", at=1)])
    with plan.activate():
        tr = _rl_run(datasets, tmp_path, rl_topology="decoupled")
    assert tr.rl_epochs == 2 and plan.fired[0]["kind"] == "actor_preempt"
    assert events_of(tmp_path / "ev", "rl_actor_fallback_sync")
    # 2 RL batches an epoch x 2 epochs: every batch still gave a step
    steps = {e["step"] for e in events_of(tmp_path / "ev", "rl_step")}
    assert len(steps) == 4
    # the fallback stops the actor's visits
    assert plan.visits("rl.actor.step") == 2
    for p in tr.state.params:
        assert torch.isfinite(p).all()


# ---- serving -------------------------------------------------------------------

SERVE = ModelConfig(vocab_size=61, modalities=(("resnet", 8),), d_embed=12,
                    d_hidden=12, d_att=6, encoder="temporal_attention",
                    dropout=0.0, max_len=10, max_frames=6, dtype="float32",
                    decode_impl="pallas", decode_stride=4)


def _serve_model(bump: int | None = None):
    model = load_flax_params(CaptionModel(SERVE, device="cpu"),
                             random_flax_params(SERVE, 0))
    with torch.no_grad():
        model.cell.out_proj.bias[EOS_ID] += 2.0
        if bump is not None:
            model.cell.out_proj.bias[bump] += 3.0
    return model


def _requests():
    out = []
    for i, F in enumerate((2, 6, 4, 6, 3)):
        rng = np.random.default_rng(200 + i)
        out.append(ClipRequest(
            req_id=f"c{i}",
            feats={"resnet": rng.normal(size=(F, 8)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)}, seed=300 + i))
    return out


def _service(model):
    return CaptionService(model, capacity=2, num_rollouts=2, stride=4,
                          frame_bucket=2, device="cpu")


def test_param_swap_preempt_is_refused_and_replays_bitwise(tmp_path):
    """Scenario 2 of scripts/chaos_smoke.py on the port's service."""
    model = _serve_model()
    base = _service(model).serve(_requests())
    plan = FaultPlan([Fault("serving.param_swap", "param_swap", at=0)])
    svc = _service(model)
    published = []

    def feedback(req, result, version):
        if not published:
            published.append(svc.publish_params(_serve_model(5)))

    svc._feedback = feedback
    snap = str(tmp_path / "swapdrain")
    with plan.activate():
        drained = svc.serve(_requests(), snapshot_dir=snap)
    assert published == [True] and plan.fired[0]["kind"] == "param_swap"
    assert drained.drained and drained.drain_reason == "chaos_param_swap"
    assert svc.param_version == 0 and svc._pending_publish is None
    assert svc._swap_history == [] and svc._old_versions == {}
    assert all(r.param_version == 0 for r in drained.results.values())
    replay = _service(model).serve(load_snapshot(snap))
    union = {**drained.results, **replay.results}
    assert set(union) == set(base.results) and replay.results
    for rid, res in base.results.items():
        assert np.array_equal(union[rid].tokens, res.tokens), rid
        assert np.array_equal(union[rid].logprobs, res.logprobs), rid


def test_serving_preempt_drains_at_the_step(tmp_path):
    model = _serve_model()
    plan = FaultPlan([Fault("serving.step", "serving_preempt", at=2)])
    with plan.activate():
        rep = _service(model).serve(_requests(),
                                    snapshot_dir=str(tmp_path / "s"))
    assert rep.drained and rep.drain_reason == "chaos_serving_preempt"
    assert plan.visits("serving.step") == 3


# ---- every one-device point fires ------------------------------------------------

TRAIN_POINTS = ("xe.step", "xe.batch", "rl.step", "rl.batch",
                "prefetch.stage", "prefetch.h2d", "ckpt.save",
                "ckpt.state_written", "ckpt.pre_replace", "reward.call",
                "rl.actor.step")


def test_every_one_device_point_fires(datasets, tmp_path):
    plan = FaultPlan([Fault(p, "slow", at=0) for p in TRAIN_POINTS]
                     + [Fault("serving.step", "slow", at=0),
                        Fault("serving.param_swap", "slow", at=0)])
    with plan.activate():
        _rl_run(datasets, tmp_path, rl_topology="decoupled", epochs=1,
                rl_epochs=1)
        model = _serve_model()
        svc = _service(model)
        published = []

        def feedback(req, result, version):
            if not published:
                published.append(svc.publish_params(_serve_model(5)))

        svc._feedback = feedback
        svc.serve(_requests())
    assert svc.param_version == 1
    assert sorted(f["point"] for f in plan.fired) == sorted(
        TRAIN_POINTS + ("serving.step", "serving.param_swap"))


# ---- peer loss under elastic="strict" ----------------------------------------------

DRAIN_FIELDS = ("phase", "step", "batch_index", "lost")


def _jax_drain(jax_train_ds, cfg, fault, log, rl: bool) -> dict:
    """The JAX trainer (one device) on the same config under the same
    fault -> its peer_loss_drain event's fields."""
    jtr = JaxTrainer(JaxExperimentConfig.from_json(cfg.to_json()),
                     jax_train_ds, None, log_path=str(log), use_mesh=False)
    try:
        with JaxFaultPlan([JaxFault(*fault[:2], at=fault[2],
                                    host=1)]).activate():
            with pytest.raises(JaxPeerLost) as e:
                jtr.train_xe()
                if rl:
                    jtr.train_rl()
    finally:
        jtr.close()
    assert e.value.hosts == [1]
    (ev,) = events_of(log, "peer_loss_drain")
    return {k: ev[k] for k in DRAIN_FIELDS}


def test_partial_preempt_xe_strict_drains_and_raises(datasets, jax_train_ds,
                                                     tmp_path):
    train_ds, _ = datasets
    obs_dir = tmp_path / "obs"
    cfg = make_cfg(tmp_path / "ck", len(train_ds.vocab), health=True,
                   health_sim_hosts=2, obs=True, obs_dir=str(obs_dir),
                   recorder_steps=8)
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    try:
        assert tr.health.survivors() == [0, 1]
        plan = FaultPlan([Fault("xe.step", "partial_preempt",
                                at=STEPS_PER_EPOCH, host=1)])
        with plan.activate():
            with pytest.raises(PeerLost) as e:
                tr.train_xe()
    finally:
        tr.close()
        obs.shutdown()
    assert e.value.hosts == [1]
    assert tr.health._thread is None     # close stopped the watchdog
    (drain,) = events_of(tmp_path / "ev", "peer_loss_drain")
    assert drain["phase"] == "xe" and drain["lost"] == [1]
    assert drain["batch_index"] == 1 and drain["step"] == STEPS_PER_EPOCH + 1
    (lost,) = events_of(tmp_path / "ev", "peer_lost")
    assert lost["host"] == 1 and lost["reason"] == "partial_preempt"
    (step_dir,) = [n for n in os.listdir(tmp_path / "ck")
                   if n.startswith("step_")]
    assert verify_manifest(str(tmp_path / "ck" / step_dir))
    assert os.path.exists(tmp_path / "ck" / "health" / "host1.dead")
    want = _jax_drain(jax_train_ds, make_cfg(
        tmp_path / "jck", len(train_ds.vocab), health=True,
        health_sim_hosts=2), ("xe.step", "partial_preempt", STEPS_PER_EPOCH),
        tmp_path / "jev", rl=False)
    assert {k: drain[k] for k in DRAIN_FIELDS} == want
    # the postmortem names the victim, and merges with the victim's bundle
    (bundle,) = [b for b in fleet.discover_bundles(str(obs_dir))[0]
                 if b.endswith("peer_loss")]
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert meta["lost"] == [1] and meta["step"] == STEPS_PER_EPOCH + 1
    fr1 = recorder.FlightRecorder(8, str(obs_dir / "proc1"), run=meta["run"],
                                  proc=1, world=2, host="simhost1")
    for step in range(1, STEPS_PER_EPOCH + 2):
        fr1.record(step, "xe", {"loss": math.nan if step == 3 else 1.0,
                                "grad_norm": 1.0})
    assert fr1.postmortem("divergence_nonfinite", phase="xe", step=3)
    fr1.close()
    merged = fleet.merge_bundles(str(obs_dir))
    assert merged["merged_procs"] == [0, 1]
    assert merged["victim_hosts"] == [1] and merged["trip"]["proc"] == 1
    assert "[TRIP]" in fleet.render_fleet(merged)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
def test_partial_preempt_strict_full_restart_is_bitwise(
        datasets, jax_train_ds, tmp_path, pipelined):
    """JAX test_chaos_train.py's strict full restart on one device: losing
    host 1 of 2 mid RL epoch 2 drains (sequential: at batch 1, after the
    epoch's first step, as the JAX test expects; pipelined, 5 batches of 2
    an epoch: mid-epoch with the seam), saves and raises; a restart from
    that save with a fresh health directory ends bitwise equal to the run
    without the loss."""
    kw = dict(health=True, health_sim_hosts=2, pipelined=pipelined)
    if pipelined:
        kw.update(batch_size=2, seq_per_vid=1)
    fault = ("rl.step", "partial_preempt", 6 if pipelined else 2)
    straight = _rl_run(datasets, tmp_path / "a", **kw)
    with FaultPlan([Fault(*fault[:2], at=fault[2], host=1)]).activate():
        with pytest.raises(PeerLost) as e:
            _rl_run(datasets, tmp_path / "b", **kw)
    assert e.value.hosts == [1]
    (drain,) = events_of(tmp_path / "b" / "ev", "peer_loss_drain")
    saves = events_of(tmp_path / "b" / "ev", "ckpt_step")
    assert drain["phase"] == "rl"
    assert saves[-1]["batch_index"] == drain["batch_index"]
    assert saves[-1]["seam"] is pipelined
    if pipelined:
        assert 1 < drain["batch_index"] < 5
    else:
        assert drain["batch_index"] == 1
    train_ds, _ = datasets
    want = _jax_drain(jax_train_ds, make_cfg(
        tmp_path / "jck", len(train_ds.vocab), epochs=1, **kw), fault,
        tmp_path / "jev", rl=True)
    assert {k: drain[k] for k in DRAIN_FIELDS} == want
    again = _rl_run(datasets, tmp_path / "b", resume="auto",
                    health_dir=str(tmp_path / "hb2"), **kw)
    assert again.rl_epochs == straight.rl_epochs == 2
    assert again.state.step == straight.state.step
    params_equal(again.state, straight.state)
    # the restart's fresh monitor lost nobody; pipelined, it replayed the seam
    assert len(events_of(tmp_path / "b" / "ev", "peer_lost")) == 1
    assert bool(events_of(tmp_path / "b" / "ev", "seam_loaded")) is pipelined


def test_watchdog_finds_a_silent_peer_and_the_epoch_drains(datasets,
                                                           tmp_path):
    """No tombstone: a second monitor (host 1) beats on its own thread
    and stops; the trainer's watchdog declares it lost by staleness within
    timeout + misses x interval, and the XE loop drains and raises."""
    train_ds, _ = datasets
    interval, timeout, misses = 0.02, 0.1, 2
    cfg = make_cfg(tmp_path, len(train_ds.vocab), epochs=50, health=True,
                   health_sim_hosts=2, health_interval_s=interval,
                   peer_timeout_s=timeout, health_misses=misses)
    tr = trainer(cfg, train_ds, log=tmp_path / "ev")
    peer = HealthMonitor(str(tmp_path / "health"), host_id=1, num_hosts=2,
                         interval_s=interval, timeout_s=timeout,
                         misses=misses).start()
    try:
        deadline = time.monotonic() + 10.0
        while tr.health._seen_seq.get(1) is None:
            assert time.monotonic() < deadline, "host 1 never seen"
            time.sleep(interval)
        peer.stop()
        t_stop = time.monotonic()
        plan = FaultPlan([Fault("xe.step", "slow", at=0, times=10 ** 6,
                                delay=interval)])
        with plan.activate():
            with pytest.raises(PeerLost) as e:
                tr.train_xe()
        waited = time.monotonic() - t_stop
    finally:
        peer.stop()
        tr.close()
    assert e.value.hosts == [1]
    (lost,) = events_of(tmp_path / "ev", "peer_lost")
    assert lost["reason"] == "heartbeat_timeout" and lost["age_s"] > timeout
    assert not os.path.exists(tmp_path / "health" / "host1.dead")
    (drain,) = events_of(tmp_path / "ev", "peer_loss_drain")
    assert drain["phase"] == "xe" and tr.xe_epochs < 50
    assert waited < 10.0
