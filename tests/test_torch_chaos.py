"""The port's chaos harness, adaptive spike bound, and the chaos seams of
its prefetch and checkpoints (cst_captioning_tpu_torch.resilience.chaos,
.adaptive, data.prefetch, ckpt.checkpoint) against the JAX package's, on
the CPU.

Fault plans draw and fire the same for the same seed and visit sequence in
both packages; the adaptive bound is exactly equal on the same loss
streams; the chaos cases of tests/test_resilience.py run against the
port's prefetch and checkpoints; the kinds that act on the health monitor
(``partial_preempt``, ``host_rejoin_flaky`` off ``rl.actor.step``) reach
the port's monitor, and the JAX point ``health.rejoin`` (the degraded
trainer's rejoin poll) raises naming the data-parallel slice.
"""

import errno
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.obs import anomaly as jax_anomaly
from cst_captioning_tpu.resilience import chaos as jax_chaos
from cst_captioning_tpu.resilience import health as jax_health
from cst_captioning_tpu.resilience.adaptive import (
    AdaptiveThresholds as JaxAdaptive,
)
from cst_captioning_tpu.resilience.sentinel import (
    DivergenceSentinel as JaxSentinel,
)
from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.ckpt import CheckpointManager, load_state
from cst_captioning_tpu_torch.config import ModelConfig, TrainConfig
from cst_captioning_tpu_torch.data.prefetch import prefetch_to_device
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.obs import anomaly as port_anomaly
from cst_captioning_tpu_torch.obs import recorder as port_recorder
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.resilience import health as port_health
from cst_captioning_tpu_torch.resilience.adaptive import AdaptiveThresholds
from cst_captioning_tpu_torch.resilience.chaos import (
    Fault,
    FaultPlan,
    PartialTransferError,
    SimulatedKill,
    TransientIOError,
)
from cst_captioning_tpu_torch.resilience.preempt import PreemptionHandler
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy
from cst_captioning_tpu_torch.resilience.sentinel import DivergenceSentinel
from cst_captioning_tpu_torch.rl import async_scst
from cst_captioning_tpu_torch.train import create_train_state, make_optimizer

torch.set_num_threads(1)


def _counter(name: str) -> float:
    return obs.counter(name).snapshot()


class LogSink:
    def __init__(self):
        self.events = []

    def __call__(self, event, **fields):
        self.events.append({"event": event, **fields})

    def of(self, kind):
        return [e for e in self.events if e["event"] == kind]


# ---- FaultPlan parity ----------------------------------------------------------

# kinds that fire without raising or signalling: the same visit sequence
# runs to its end in both packages
QUIET = [("a", "slow"), ("b", "nan"), ("a", "slow_h2d"),
         ("c", "wedged_prefetch"), ("b", "slow")]


def _plan_spec(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i, (point, kind) in enumerate(QUIET):
        at = (("rand", 0, 12) if i % 2 == 0
              else int(rng.integers(0, 10)))
        out.append(dict(point=point, kind=kind, at=at,
                        times=int(rng.integers(1, 4)), host=i))
    return out


def _drive(mod, spec, seed, visits):
    plan = mod.FaultPlan([mod.Fault(**f) for f in spec], seed=seed)

    class B:
        def __init__(self):
            self.feats = {"resnet": np.ones((2, 3), np.float32)}

    poisoned = []
    with plan.activate():
        for point in visits:
            b = B()
            mod.visit(point, b)
            poisoned.append(bool(np.isnan(b.feats["resnet"]).all()))
    return plan, poisoned


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_draws_and_fires_as_jax(seed):
    spec = _plan_spec(seed)
    visits = list(np.random.default_rng(100 + seed).choice(
        ["a", "b", "c", "d"], size=80))
    jp, jpois = _drive(jax_chaos, spec, seed, visits)
    tp, tpois = _drive(chaos, spec, seed, visits)
    assert [f.at for f in tp.faults] == [f.at for f in jp.faults]
    assert [(f.point, f.kind, f.times, f.host) for f in tp.faults] == \
        [(f.point, f.kind, f.times, f.host) for f in jp.faults]
    assert tp.fired == jp.fired and tp.fired
    assert tpois == jpois and any(tpois)
    for p in "abcd":
        assert tp.visits(p) == jp.visits(p)


def test_every_jax_kind_constructs():
    assert Fault._KINDS == jax_chaos.Fault._KINDS
    for kind in Fault._KINDS:
        Fault("xe.step", kind)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("xe.step", "meteor_strike")
    with pytest.raises(ValueError, match="must be >= 1"):
        Fault("xe.step", "kill", times=0)
    with pytest.raises(ValueError, match="bad fault at-spec"):
        FaultPlan([Fault("pt", "kill", at=("uniform", 0, 3))])
    plan = FaultPlan([Fault("rl.step", "partial_preempt", at=("rand", 2, 5),
                            host=7)], seed=11)
    assert 2 <= plan.faults[0].at < 5 and plan.faults[0].host == 7


def test_inactive_visit_returns_the_payload():
    payload = object()
    assert chaos.visit("anything", payload) is payload
    assert chaos._ACTIVE is None


def test_chaos_imports_neither_serving_nor_rl():
    """``cli.obs_report`` imports the harness; serving and RL (and torch)
    load only when a fault needs them."""
    probe = ("import json, sys\n"
             "import cst_captioning_tpu_torch.resilience.chaos\n"
             "import cst_captioning_tpu_torch.cli.obs_report\n"
             "print(json.dumps(sorted(k for k in sys.modules if k in "
             "('torch', 'cst_captioning_tpu_torch.serving', "
             "'cst_captioning_tpu_torch.rl'))))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         env={**os.environ, "PYTHONPATH": repo},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_kill_fires_at_exact_visit_and_counts():
    before = (_counter("resilience.chaos_fault"),
              _counter("resilience.chaos_fault.kill"))
    plan = FaultPlan([Fault("pt", "kill", at=2)])
    with plan.activate():
        chaos.visit("pt")
        chaos.visit("pt")
        with pytest.raises(SimulatedKill):
            chaos.visit("pt")
    assert plan.fired == [{"point": "pt", "kind": "kill", "visit": 2}]
    assert not isinstance(SimulatedKill("x"), Exception)
    assert (_counter("resilience.chaos_fault"),
            _counter("resilience.chaos_fault.kill")) == (before[0] + 1,
                                                         before[1] + 1)
    chaos.visit("pt")   # deactivated


def test_io_error_window_then_clean_and_single_active_plan():
    plan = FaultPlan([Fault("io", "io_error", at=0, times=2)])
    with plan.activate():
        for _ in range(2):
            with pytest.raises(TransientIOError):
                chaos.visit("io")
        chaos.visit("io")
        with pytest.raises(RuntimeError, match="already active"):
            FaultPlan([]).activate().__enter__()
    assert plan.visits("io") == 3
    assert isinstance(TransientIOError("x"), OSError)


def test_raising_kinds_carry_their_types():
    plan = FaultPlan([Fault("prefetch.h2d", "partial_h2d", at=0),
                      Fault("ckpt.save", "enospc_rotation", at=0)])
    with plan.activate():
        with pytest.raises(PartialTransferError):
            chaos.visit("prefetch.h2d")
        chaos.visit("prefetch.h2d")
        with pytest.raises(OSError) as ei:
            chaos.visit("ckpt.save")
    assert ei.value.errno == errno.ENOSPC
    assert isinstance(PartialTransferError("x"), TransientIOError)
    assert [f["kind"] for f in plan.fired] == ["partial_h2d",
                                               "enospc_rotation"]


@pytest.mark.parametrize("point,kind", [
    ("rl.step", "partial_preempt"), ("health.rejoin", "host_rejoin"),
    ("xe.step", "host_rejoin_flaky")])
def test_health_kinds_raise_naming_the_health_slice(point, kind, tmp_path):
    """The three health kinds of the JAX chaos tests. ``partial_preempt``
    and ``host_rejoin`` / ``host_rejoin_flaky`` (off ``rl.actor.step``;
    ``health.rejoin`` is the degraded trainer's rejoin poll) act on the
    port's monitor, each package's alike, and raise only with no active
    monitor; a ``host_rejoin`` where the hosts are real processes raises,
    naming the host to restart."""
    out = {}
    for name, ch, health in (("jax", jax_chaos, jax_health),
                             ("port", chaos, port_health)):
        plan = ch.FaultPlan([ch.Fault(point, kind, at=0, host=1)])
        with plan.activate():
            with pytest.raises(RuntimeError, match="HealthMonitor"):
                ch.visit(point)
        d = str(tmp_path / name)
        mon = health.HealthMonitor(d, host_id=0, num_hosts=2,
                                   start_thread=False).start()
        try:
            if kind in ("host_rejoin", "host_rejoin_flaky"):
                mon.simulate_loss(1)
                mon.acknowledge()
            plan = ch.FaultPlan([ch.Fault(point, kind, at=1, host=1)])
            with plan.activate():
                ch.visit(point)
                before = (mon.peer_lost, mon.lost(),
                          sorted(mon.pending_rejoins()))
                ch.visit(point)
            out[name] = (before, mon.peer_lost, mon.lost(),
                         sorted(mon.pending_rejoins()), sorted(os.listdir(d)),
                         plan.fired)
        finally:
            mon.stop()
    assert out["port"] == out["jax"]
    if kind == "partial_preempt":
        assert out["port"][:3] == ((False, [], []), True, [1])
    else:
        assert out["port"][3] == [1] and "host1.rejoin" in out["port"][4]
    if kind == "host_rejoin":
        # the rendezvous marker of a whole rejoin, and no such process on
        # real hosts
        assert "rendezvous_0001" in out["port"][4]
        mon = port_health.HealthMonitor(str(tmp_path / "real"), host_id=0,
                                        num_hosts=2,
                                        start_thread=False).start()
        try:
            mon.real_hosts = True
            mon.simulate_loss(1)
            plan = FaultPlan([Fault(point, kind, at=0, host=1)])
            with plan.activate():
                with pytest.raises(RuntimeError, match="restart host 1"):
                    chaos.visit(point)
            assert mon.pending_rejoins() == {}
        finally:
            mon.stop()


def test_actor_kinds_queue_on_the_decoupled_trainer():
    async_scst._PREEMPT_REQUESTS.clear()
    async_scst._REJOIN_REQUESTS.clear()
    plan = FaultPlan([Fault("rl.actor.step", "actor_preempt", at=0, host=1),
                      Fault("rl.actor.step", "host_rejoin", at=1, host=1)])
    try:
        with plan.activate():
            chaos.visit("rl.actor.step")
            chaos.visit("rl.actor.step")
        assert async_scst._PREEMPT_REQUESTS == [1]
        assert async_scst._REJOIN_REQUESTS == [1]
    finally:
        async_scst._PREEMPT_REQUESTS.clear()
        async_scst._REJOIN_REQUESTS.clear()


def test_serving_kinds_need_a_serving_service():
    plan = FaultPlan([Fault("serving.step", "serving_preempt", at=0)])
    with plan.activate():
        with pytest.raises(RuntimeError, match="no CaptionService serving"):
            chaos.visit("serving.step")


def test_preempt_kind_signals_the_installed_handler():
    plan = FaultPlan([Fault("xe.step", "preempt", at=1)])
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        with plan.activate():
            chaos.visit("xe.step")
            assert not h.requested
            chaos.visit("xe.step")
        assert h.requested
    assert signal.getsignal(signal.SIGTERM) == prev


def test_nan_poisons_the_collated_batch_not_a_read_only_cache():
    cache = np.ones((2, 3), np.float32)
    cache.flags.writeable = False

    class B:
        feats = {"resnet": cache.copy()}

    plan = FaultPlan([Fault("b", "nan", at=0)])
    with plan.activate():
        b = chaos.visit("b", B())
    assert np.isnan(b.feats["resnet"]).all() and np.isfinite(cache).all()
    with FaultPlan([Fault("b", "nan", at=0)]).activate():
        with pytest.raises(ValueError, match="no batch payload"):
            chaos.visit("b")


def test_postmortem_is_noted_before_the_fault_fires(tmp_path, monkeypatch):
    seen = []
    real = port_recorder.note_fault

    def note(point, kind, visit, **fields):
        seen.append((point, kind, visit, fields))
        real(point, kind, visit, **fields)

    monkeypatch.setattr(port_recorder, "note_fault", note)
    fr = port_recorder.configure(4, str(tmp_path), run="chaos")
    try:
        fr.record(1, "xe", {"loss": torch.tensor(2.0)})
        plan = FaultPlan([Fault("pt", "kill", at=0)])
        with plan.activate():
            with pytest.raises(SimulatedKill):
                chaos.visit("pt")
    finally:
        port_recorder.shutdown()
    assert seen == [("pt", "kill", 0, {})]
    (bundle,) = [d for d in os.listdir(tmp_path)
                 if d.startswith("postmortem_")]
    meta = json.load(open(tmp_path / bundle / "meta.json"))
    assert meta["reason"] == "chaos_kill" and meta["point"] == "pt"
    assert meta["steps"] == [1]


# ---- the adaptive spike bound --------------------------------------------------

def _bounds(cls, losses, **kw):
    at = cls(factor_max=10.0, factor_min=1.5, **kw)
    out = []
    for v in losses:
        out.append(at.bound(float(np.median(losses[:8])), 20.0))
        at.observe(float(v))
    return out, at


def _ramp():
    rng = np.random.default_rng(0)
    return list(2.0 + rng.normal(0.0, 0.02, size=40)) + \
        [2.0 * 1.10 ** k for k in range(1, 25)]


STREAMS = {
    "ramp": _ramp(),
    "healthy": list(2.0 + np.random.default_rng(3).normal(0.0, 0.05, 200)),
    "flat": [2.0] * 20,
    "quiet": list(2.0 + np.random.default_rng(1).normal(0.0, 0.01, 32)),
    "negative": list(-0.5 + np.random.default_rng(2).normal(0.0, 0.1, 40)),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_adaptive_bound_equals_jax(stream):
    losses = [float(v) for v in STREAMS[stream]]
    for kw in ({}, {"alpha": 0.2, "warmup": 4}):
        want, jat = _bounds(JaxAdaptive, losses, **kw)
        got, tat = _bounds(AdaptiveThresholds, losses, **kw)
        assert got == want
        assert tat.warmed == jat.warmed
        for med, fixed in ((2.0, 20.0), (2.0, 2.5), (-0.5, 20.0)):
            assert tat.bound(med, fixed) == jat.bound(med, fixed)


def test_adaptive_unwarmed_and_clamps():
    at = AdaptiveThresholds(factor_max=10.0, factor_min=1.5)
    assert not at.warmed and at.bound(2.0, 20.0) == 20.0
    for _ in range(16):
        at.observe(2.0)
    assert not at.warmed and at.bound(2.0, 20.0) == 20.0
    at = AdaptiveThresholds(factor_max=10.0, factor_min=1.5, alpha=0.2,
                            warmup=4)
    for v in STREAMS["quiet"]:
        at.observe(float(v))
    assert at.warmed
    assert at.bound(2.0, 20.0) == pytest.approx(3.0, rel=1e-6)
    assert at.bound(2.0, 2.5) == 2.5
    assert 2.0 < at.bound(-0.5, 20.0) < 2.2


def test_adaptive_shared_ewma_equals_jax():
    jdet = jax_anomaly.AnomalyDetector(warmup=4)
    tdet = port_anomaly.AnomalyDetector(warmup=4)
    jat = JaxAdaptive(factor_max=10.0, ewma=jdet.ewma("loss"))
    tat = AdaptiveThresholds(factor_max=10.0, ewma=tdet.ewma("loss"))
    tat.observe(5.0)    # shared: the detector owns the updates
    assert tdet.ewma("loss").n == 0
    for i in range(12):
        jdet.observe("loss", 2.0 + 0.01 * i)
        tdet.observe("loss", 2.0 + 0.01 * i)
        assert tat.bound(2.0, 20.0) == jat.bound(2.0, 20.0)
    assert tat.warmed and tat.bound(2.0, 20.0) < 20.0


BAD_ADAPTIVE = [dict(factor_max=0.0), dict(factor_max=10.0, factor_min=0.0),
                dict(factor_max=10.0, factor_min=12.0),
                dict(factor_max=10.0, z=0.0)]


@pytest.mark.parametrize("kw", BAD_ADAPTIVE,
                         ids=["max", "min_zero", "min_above", "z"])
def test_adaptive_validation_messages_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxAdaptive(**kw)
    with pytest.raises(ValueError) as got:
        AdaptiveThresholds(**kw)
    assert str(got.value) == str(want.value)


def _spikes(sentinel_cls, losses, adaptive):
    log = LogSink()
    s = sentinel_cls(policy="skip_batch", log=log, spike_factor=10.0,
                     warmup=4, adaptive=adaptive)
    for i, v in enumerate(losses):
        s.push(i, float(v), None)
        if i % 8 == 7:
            s.flush()
    s.flush()
    return [(e["step"], e["loss"], e["bound"]) for e in log.of("divergence")
            if e["kind"] == "spike"]


def test_sentinel_adaptive_trips_on_a_ramp_as_jax():
    losses = STREAMS["ramp"]
    assert _spikes(DivergenceSentinel, losses, None) == []
    got = _spikes(DivergenceSentinel, losses,
                  AdaptiveThresholds(factor_max=10.0, factor_min=1.5))
    want = _spikes(JaxSentinel, losses,
                   JaxAdaptive(factor_max=10.0, factor_min=1.5))
    assert got == want and got
    assert 40 <= got[0][0] <= 48 and 0.0 < got[0][2] < got[0][1]
    for seed in range(3):
        healthy = list(2.0 + np.random.default_rng(seed).normal(0, 0.05, 400))
        assert _spikes(DivergenceSentinel, healthy, AdaptiveThresholds(
            factor_max=10.0, factor_min=1.5)) == []


# ---- prefetch under faults -----------------------------------------------------

def _arrays(i):
    rng = np.random.default_rng(i)
    return {"feats": rng.normal(size=(2, 3)).astype(np.float32),
            "ids": rng.integers(0, 9, size=(4,))}


def test_prefetch_partial_h2d_is_retried_and_every_item_arrives():
    clean = list(prefetch_to_device(range(4), size=2, transform=_arrays,
                                    device="cpu"))
    before = _counter("resilience.h2d_retry")
    plan = FaultPlan([Fault("prefetch.h2d", "partial_h2d", at=1)])
    with plan.activate():
        got = list(prefetch_to_device(range(4), size=2, transform=_arrays,
                                      device="cpu"))
    assert [f["kind"] for f in plan.fired] == ["partial_h2d"]
    assert plan.visits("prefetch.h2d") == 5
    assert _counter("resilience.h2d_retry") == before + 1
    for a, b in zip(got, clean):
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
    # place=False: the JAX test's shape
    with FaultPlan([Fault("prefetch.h2d", "partial_h2d", at=1)]).activate():
        assert list(prefetch_to_device(range(4), size=2,
                                       transform=lambda x: x * 10,
                                       place=False, device="cpu")) == \
            [0, 10, 20, 30]


def test_prefetch_h2d_retry_budget_exhausted_propagates():
    plan = FaultPlan([Fault("prefetch.h2d", "partial_h2d", at=0, times=10)])
    with plan.activate():
        with pytest.raises(PartialTransferError):
            list(prefetch_to_device(range(2), size=1, place=False,
                                    device="cpu"))
    assert plan.visits("prefetch.h2d") == 3


def test_prefetch_slow_h2d_and_wedged_worker():
    with FaultPlan([Fault("prefetch.h2d", "slow_h2d", at=0,
                          delay=0.05)]).activate():
        assert list(prefetch_to_device(range(3), size=2, place=False,
                                       device="cpu")) == [0, 1, 2]
    before = _counter("resilience.prefetch_stall")
    plan = FaultPlan([Fault("prefetch.stage", "wedged_prefetch", at=1,
                            delay=0.4)])
    with plan.activate():
        got = list(prefetch_to_device(range(3), size=1, place=False,
                                      stall_warn_s=0.05, device="cpu"))
    assert got == [0, 1, 2]
    assert _counter("resilience.prefetch_stall") == before + 1
    assert plan.fired[0]["kind"] == "wedged_prefetch"


def test_a_kill_on_the_prefetch_worker_reaches_the_consumer():
    plan = FaultPlan([Fault("prefetch.stage", "kill", at=2)])
    got = []
    with plan.activate():
        with pytest.raises(SimulatedKill):
            for x in prefetch_to_device(range(5), size=1, place=False,
                                        device="cpu"):
                got.append(x)
    assert got == [0, 1]


# ---- checkpoints under faults --------------------------------------------------

@pytest.fixture(scope="module")
def tiny_state():
    cfg = ModelConfig(vocab_size=12, modalities=(("resnet", 6),), d_embed=8,
                      d_hidden=8, d_att=4, encoder="meanpool", max_len=5,
                      max_frames=3, dtype="float32")
    model = CaptionModel(cfg, device="cpu")
    return create_train_state(model, make_optimizer(TrainConfig(lr=1e-3), 10))


def test_kill_mid_save_keeps_the_previous_generation(tiny_state, tmp_path):
    log = LogSink()
    mgr = CheckpointManager(str(tmp_path), log=log)
    mgr.save(tiny_state, value=None, infos={"epoch": 1, "global_step": 5})
    for point in ("ckpt.state_written", "ckpt.pre_replace"):
        with FaultPlan([Fault(point, "kill", at=0)]).activate():
            with pytest.raises(SimulatedKill):
                mgr.save(tiny_state, value=None,
                         infos={"epoch": 2, "global_step": 10})
        assert os.path.isdir(tmp_path / "latest.tmp")
        restored = mgr.restore_latest(tiny_state)
        assert restored is not None and restored[1]["epoch"] == 1
        assert log.of("ckpt_corrupt") == []
    mgr.save(tiny_state, value=None, infos={"epoch": 3, "global_step": 15})
    assert mgr.restore_latest(tiny_state)[1]["epoch"] == 3
    assert not os.path.exists(tmp_path / "latest.tmp")
    _, prev = load_state(str(tmp_path), "latest.prev", tiny_state)
    assert prev["epoch"] == 1


def test_save_retries_transient_io_errors(tiny_state, tmp_path):
    log = LogSink()
    mgr = CheckpointManager(str(tmp_path), log=log,
                            retry=RetryPolicy(max_attempts=4,
                                              base_delay=0.001))
    with FaultPlan([Fault("ckpt.save", "io_error", at=0,
                          times=2)]).activate():
        mgr.save(tiny_state, value=None, infos={"epoch": 1})
    assert [e["error"] for e in log.of("ckpt_retry")] == \
        ["TransientIOError"] * 2
    assert mgr.restore_latest(tiny_state) is not None


@pytest.mark.parametrize("point", ["ckpt.save", "ckpt.state_written"])
def test_enospc_reclaims_the_oldest_generation(tiny_state, tmp_path, point):
    sink = LogSink()
    mgr = CheckpointManager(str(tmp_path), keep=3, log=sink,
                            retry=RetryPolicy(max_attempts=3, base_delay=0.0,
                                              max_delay=0.0))
    mgr.save_step(tiny_state, 100)
    mgr.save_step(tiny_state, 200)
    before = _counter("resilience.ckpt_enospc")
    plan = FaultPlan([Fault(point, "enospc_rotation", at=0)])
    with plan.activate():
        mgr.save_step(tiny_state, 300)
    assert [f["kind"] for f in plan.fired] == ["enospc_rotation"]
    assert [s for s, _ in mgr.step_checkpoints()] == [200, 300]
    (ev,) = sink.of("ckpt_enospc")
    assert ev["freed"] == ["step_00000100"]
    assert _counter("resilience.ckpt_enospc") == before + 1
    assert mgr.restore_latest(tiny_state)[1]["global_step"] == 300


def test_enospc_with_nothing_to_reclaim_gives_up(tiny_state, tmp_path):
    sink = LogSink()
    mgr = CheckpointManager(str(tmp_path), keep=3, log=sink,
                            retry=RetryPolicy(max_attempts=2, base_delay=0.0,
                                              max_delay=0.0))
    with FaultPlan([Fault("ckpt.save", "enospc_rotation", at=0,
                          times=5)]).activate():
        with pytest.raises(OSError):
            mgr.save_step(tiny_state, 100)
    assert sink.of("ckpt_enospc") and all(
        ev["freed"] == [] for ev in sink.of("ckpt_enospc"))
