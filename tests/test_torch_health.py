"""The port's health monitor (cst_captioning_tpu_torch.resilience.health)
against the JAX package's, on the CPU, exact.

- every health case of tests/test_resilience.py runs through both
  packages' monitors on one injected clock, each on its own tmp dir: the
  same lost sets, survivors, rendezvous results and sleeps, refusal types
  and messages, logged events, counter and gauge snapshots, and the same
  files on disk with the same JSON keys (heartbeats, tombstones, rejoin and
  rendezvous markers);
- the ``partial_preempt`` and ``host_rejoin`` / ``host_rejoin_flaky``
  chaos kinds act on each package's active monitor the same way;
- interop: a JAX monitor and a port monitor share one directory and see
  each other's heartbeats, silence and tombstones;
- the port's watchdog thread beats and detects on its own.
"""

import json
import os
import time
import types

import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu import obs as jobs
from cst_captioning_tpu.resilience import chaos as jchaos
from cst_captioning_tpu.resilience import health as jhealth
from cst_captioning_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from cst_captioning_tpu_torch import obs as tobs
from cst_captioning_tpu_torch.resilience import chaos as tchaos
from cst_captioning_tpu_torch.resilience import health as thealth
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, health=jhealth, chaos=jchaos,
                                 RetryPolicy=JaxRetryPolicy),
    "port": types.SimpleNamespace(obs=tobs, health=thealth, chaos=tchaos,
                                  RetryPolicy=RetryPolicy),
}


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both registries are process-global; each case starts and ends
    clean, with no active monitor left behind."""
    for pkg in PKGS.values():
        pkg.obs.REGISTRY.reset()
    yield
    for pkg in PKGS.values():
        mon = pkg.health.active_monitor()
        if mon is not None:
            mon.stop()
        pkg.obs.REGISTRY.reset()


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _disk(d: str) -> list:
    """Every file under ``d``: its path and JSON keys, its values but the
    wall-clock ``ts``."""
    out = []
    for root, _, files in os.walk(d):
        for name in sorted(files):
            path = os.path.join(root, name)
            try:
                rec = json.load(open(path))
            except ValueError:
                rec = {"<unparsed>": open(path).read()}
            body = ({k: v for k, v in rec.items() if k != "ts"}
                    if isinstance(rec, dict) else rec)
            out.append((os.path.relpath(path, d),
                        sorted(rec) if isinstance(rec, dict) else None, body))
    return sorted(out, key=lambda r: r[0])


def _raised(fn) -> tuple:
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _metrics(pkg) -> dict:
    snap = pkg.obs.snapshot()
    return {"counters": snap["counters"],
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("health.")},
            "histograms": sorted(snap["histograms"])}


def _run(scenario, tmp_path) -> dict:
    """``scenario(pkg, dir, clock, log)`` through both packages -> the
    port's outcome, after holding it equal to the JAX package's."""
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir(parents=True)
        logged = []
        res = scenario(pkg, str(d), Clock(),
                       lambda event, **f: logged.append((event, f)))
        out[name] = {"result": res, "log": logged, "disk": _disk(str(d)),
                     "metrics": _metrics(pkg)}
        mon = pkg.health.active_monitor()
        if mon is not None:
            mon.stop()
    assert out["port"] == out["jax"]
    return out["port"]


def _mon(pkg, d, clock, log, **kw):
    kw.setdefault("num_hosts", 2)
    return pkg.health.HealthMonitor(d, clock=clock, log=log,
                                    start_thread=False, **kw).start()


# ---- the monitor ---------------------------------------------------------------


def _beats_then_silence(pkg, d, clock, log):
    a = _mon(pkg, d, clock, log, host_id=0, timeout_s=1.0, misses=2)
    b = _mon(pkg, d, clock, None, host_id=1, timeout_s=1.0, misses=2)
    steps = []
    b.beat()
    steps.append((a.poll(), a.peer_lost, a.survivors()))
    clock.t = 0.9
    b.beat(step=7)
    steps.append((a.poll(), a.peer_lost))
    clock.t = 2.0           # the first stale poll is a strike
    steps.append((a.poll(), a.peer_lost))
    clock.t = 2.1           # the second declares the loss
    steps.append((a.poll(), a.peer_lost, a.lost(), a.survivors()))
    a.acknowledge()
    steps.append((a.peer_lost, a.lost()))
    b.stop()
    return steps


def _never_seen_peer(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0, num_hosts=3, timeout_s=0.5,
               misses=1)
    clock.t = 100.0
    return mon.poll(), mon.peer_lost, mon.survivors()


def _simulate_loss(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0, num_hosts=3)
    mon.note_step(12)
    mon.beat()
    mon.simulate_loss(1)
    return (mon.peer_lost, mon.lost(), mon.survivors(),
            _raised(lambda: mon.simulate_loss(0)),
            _raised(lambda: mon.simulate_loss(5)),
            mon.poll(), mon.lost())


def _record_collective(pkg, d, clock, log):
    a = _mon(pkg, d, clock, log, host_id=0, timeout_s=1.0, misses=1)
    b = _mon(pkg, d, clock, None, host_id=1)
    b.beat()
    first = a.poll()
    clock.t = 5.0
    a.record_collective()
    clock.t = 5.5
    second = a.poll()
    clock.t = 6.6
    third = a.poll()
    b.stop()
    return first, second, a.peer_lost, third, a.lost()


def _tombstone_of_a_peer(pkg, d, clock, log):
    a = _mon(pkg, d, clock, log, host_id=0, num_hosts=3)
    with open(os.path.join(d, "host2.dead"), "w") as f:
        f.write("{}")
    return a.poll(), a.poll(), a.lost(), a.survivors()


def _membership(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=1, num_hosts=4)
    mon.simulate_loss(3)
    mon.acknowledge()
    mon.set_membership([0, 1])
    mon.generation += 1
    return (sorted(mon.peers), mon.lost(), mon.survivors(), mon.generation,
            mon.peer_lost)


def _bad_knobs(pkg, d, clock, log):
    ctor = pkg.health.HealthMonitor
    return [_raised(lambda kw=kw: ctor(d, start_thread=False, **kw))
            for kw in (dict(host_id=2, num_hosts=2), dict(num_hosts=0),
                       dict(interval_s=0.0), dict(timeout_s=-1.0),
                       dict(misses=0))]


def _restart_clears_own_tombstone(pkg, d, clock, log):
    a = _mon(pkg, d, clock, log, host_id=0)
    a.simulate_loss(1)
    had = os.path.exists(os.path.join(d, "host1.dead"))
    b = _mon(pkg, d, clock, None, host_id=1)
    b.stop()
    return had, os.path.exists(os.path.join(d, "host1.dead"))


# ---- rendezvous ------------------------------------------------------------------


def _rendezvous_complete(pkg, d, clock, log):
    gen = os.path.join(d, "rendezvous_0003")
    os.makedirs(gen)
    with open(os.path.join(gen, "host1.json"), "w") as f:
        f.write('{"host": 1}')
    return pkg.health.rendezvous(d, host_id=0, hosts=[0, 1], generation=3,
                                 timeout_s=1.0, sleep=lambda s: None)


def _rendezvous_timeout(pkg, d, clock, log):
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clock.sleep(s)

    err = _raised(lambda: pkg.health.rendezvous(
        d, host_id=0, hosts=[0, 2], generation=0, timeout_s=1.0,
        clock=clock, sleep=sleep))
    return err, sleeps


def _rendezvous_backoff(pkg, d, clock, log):
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clock.sleep(s)

    err = _raised(lambda: pkg.health.rendezvous(
        d, host_id=0, hosts=[0, 1], generation=1, timeout_s=1.0,
        poll_s=0.1, backoff=2.0, max_poll_s=0.5, clock=clock, sleep=sleep))
    return err, sleeps


# ---- rejoin ------------------------------------------------------------------------


def _rejoin_round_trip(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0, misses=2)
    mon.simulate_loss(1)
    mon.acknowledge()
    out = [mon.survivors()]
    mon.simulate_recovery(1)
    out.append((os.path.exists(os.path.join(d, "host1.rejoin")),
                os.path.exists(os.path.join(d, "host1.dead")),
                sorted(mon.pending_rejoins())))
    marker = mon.validate_rejoin(1, mon.generation + 1)
    out.append({k: v for k, v in marker.items() if k != "ts"})
    mon.readmit(1)
    out.append((mon.survivors(), mon.lost(),
                os.path.exists(os.path.join(d, "host1.rejoin"))))
    out.append(_raised(lambda: mon.readmit(1)))
    out.append(_raised(lambda: mon.simulate_recovery(1)))
    out.append(_raised(lambda: mon.simulate_recovery(0)))
    return out


def _rejoin_stale_generation(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0, misses=1)
    mon.simulate_loss(1)
    mon.acknowledge()
    mon.announce_rejoin(1, host=1)
    stale = _raised(lambda: mon.validate_rejoin(1, 2))
    mon.announce_rejoin(2, host=1)
    silent = _raised(lambda: mon.validate_rejoin(1, 2))
    return stale, silent, mon.survivors(), mon.lost()


def _rejoin_not_lost(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0)
    mon.announce_rejoin(1, host=1)
    return _raised(lambda: mon.validate_rejoin(1, 1)), mon.pending_rejoins()


def _rejoin_dead_incarnation(pkg, d, clock, log):
    a = _mon(pkg, d, clock, log, host_id=0, timeout_s=1.0, misses=1)
    b = _mon(pkg, d, clock, None, host_id=1, timeout_s=1.0, misses=1)
    b.beat()
    a.poll()
    a.simulate_loss(1)
    a.acknowledge()
    a.announce_rejoin(a.generation + 1, host=1)
    err = _raised(lambda: a.validate_rejoin(1, a.generation + 1))
    b.stop()
    return err


def _attempt_rejoin_budget(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0)
    mon.simulate_loss(1)
    mon.acknowledge()
    sleeps = []
    policy = pkg.RetryPolicy(max_attempts=3, base_delay=0.01, budget=10.0,
                             retry_on=(pkg.health.RejoinRefused, OSError))
    err = _raised(lambda: pkg.health.attempt_rejoin(
        mon, 1, 1, policy=policy, sleep=sleeps.append))
    return err, sleeps, mon.survivors(), mon.lost()


def _attempt_rejoin_admits(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0, misses=2)
    mon.simulate_loss(1)
    mon.acknowledge()
    mon.simulate_recovery(1)
    sleeps = []
    marker = pkg.health.attempt_rejoin(mon, 1, mon.generation + 1,
                                       sleep=sleeps.append)
    mon.readmit(1)
    return marker["generation"], sleeps, mon.survivors()


def _rejoin_marker_torn(pkg, d, clock, log):
    mon = _mon(pkg, d, clock, log, host_id=0)
    mon.simulate_loss(1)
    mon.acknowledge()
    with open(os.path.join(d, "host1.rejoin"), "w") as f:
        f.write('{"host": 1, "generat')
    out = [mon.read_rejoin(1), mon.pending_rejoins(),
           _raised(lambda: mon.validate_rejoin(1, 1))]
    with open(os.path.join(d, "host1.rejoin"), "w") as f:
        f.write("[1, 2]")
    out.append(mon.read_rejoin(1))
    mon.clear_rejoin(1)
    mon.clear_rejoin(1)     # twice: the second finds nothing
    mon.beat()
    mon.announce_rejoin(1)
    out.append([n for n in os.listdir(d) if ".tmp" in n])
    return out


# ---- chaos kinds and the DCN-stall probe ---------------------------------------------


def _chaos_partial_preempt(pkg, d, clock, log):
    no_monitor = FaultPlanRun(pkg, [("rl.step", "partial_preempt", 0, 1)])
    mon = _mon(pkg, d, clock, log, host_id=0)
    plan = pkg.chaos.FaultPlan(
        [pkg.chaos.Fault("rl.step", "partial_preempt", at=1, host=1)])
    with plan.activate():
        pkg.chaos.visit("rl.step")
        before = mon.peer_lost
        pkg.chaos.visit("rl.step")
    return no_monitor, before, mon.peer_lost, mon.lost(), plan.fired


def FaultPlanRun(pkg, faults, point=None):
    """Fire one fault plan with no active monitor -> what it raised."""
    plan = pkg.chaos.FaultPlan([pkg.chaos.Fault(p, k, at=a, host=h)
                                for p, k, a, h in faults])
    with plan.activate():
        return _raised(lambda: pkg.chaos.visit(point or faults[0][0]))


def _chaos_host_rejoin(pkg, d, clock, log):
    no_monitor = FaultPlanRun(pkg, [("xe.step", "host_rejoin", 0, 1)])
    mon = _mon(pkg, d, clock, log, host_id=0, misses=1)
    mon.simulate_loss(1)
    mon.acknowledge()
    gen = mon.generation + 1
    checkin = os.path.join(d, f"rendezvous_{gen:04d}", "host1.json")
    plan = pkg.chaos.FaultPlan(
        [pkg.chaos.Fault("xe.step", "host_rejoin_flaky", at=0, host=1)])
    with plan.activate():
        pkg.chaos.visit("xe.step")
    flaky = (sorted(mon.pending_rejoins()),
             mon.validate_rejoin(1, gen)["generation"],
             os.path.exists(checkin))
    plan2 = pkg.chaos.FaultPlan(
        [pkg.chaos.Fault("xe.step", "host_rejoin", at=0, host=1)])
    with plan2.activate():
        pkg.chaos.visit("xe.step")
    return no_monitor, flaky, os.path.exists(checkin), plan.fired, plan2.fired


def _collective_span(pkg, d, clock, log):
    b = _mon(pkg, d, clock, None, host_id=1)
    # started last, so the active monitor the span refreshes
    mon = _mon(pkg, d, clock, log, host_id=0, timeout_s=1.0, misses=1)
    b.beat()
    mon.poll()
    clock.t = 3.0
    with pkg.health.collective_span("fast", stall_threshold_s=1e9):
        pass
    after_fast = mon.poll()
    pkg.health.set_dcn_stall_threshold(0.0)
    try:
        with pkg.health.collective_span("stalled"):
            pass
    finally:
        pkg.health.set_dcn_stall_threshold(2.0)
    b.stop()
    return after_fast, mon.lost()


CASES = {
    "beats_then_silence": _beats_then_silence,
    "never_seen_peer": _never_seen_peer,
    "simulate_loss": _simulate_loss,
    "record_collective": _record_collective,
    "tombstone_of_a_peer": _tombstone_of_a_peer,
    "membership": _membership,
    "bad_knobs": _bad_knobs,
    "restart_clears_own_tombstone": _restart_clears_own_tombstone,
    "rendezvous_complete": _rendezvous_complete,
    "rendezvous_timeout": _rendezvous_timeout,
    "rendezvous_backoff": _rendezvous_backoff,
    "rejoin_round_trip": _rejoin_round_trip,
    "rejoin_stale_generation": _rejoin_stale_generation,
    "rejoin_not_lost": _rejoin_not_lost,
    "rejoin_dead_incarnation": _rejoin_dead_incarnation,
    "attempt_rejoin_budget": _attempt_rejoin_budget,
    "attempt_rejoin_admits": _attempt_rejoin_admits,
    "rejoin_marker_torn": _rejoin_marker_torn,
    "chaos_partial_preempt": _chaos_partial_preempt,
    "chaos_host_rejoin": _chaos_host_rejoin,
    "collective_span": _collective_span,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitor_matches_jax(case, tmp_path):
    _run(CASES[case], tmp_path)


def test_the_cases_hold_the_jax_gates(tmp_path):
    """A few of the JAX tests' own gates, on the port's outcomes (the rest
    follow from the equality above)."""
    got = _run(_beats_then_silence, tmp_path / "a")["result"]
    assert got[2] == ([], False) and got[3] == ([1], True, [1], [0])
    assert got[4] == (False, [1])
    err, sleeps = _run(_rendezvous_timeout, tmp_path / "b")["result"]
    assert err[0] == "RendezvousTimeout" and "[2]" in err[1]
    _, sleeps = _run(_rendezvous_backoff, tmp_path / "c")["result"]
    assert sleeps[:2] == pytest.approx([0.1, 0.2])
    assert max(sleeps) <= 0.5 + 1e-9
    err, sleeps, surv, lost = _run(_attempt_rejoin_budget,
                                   tmp_path / "d")["result"]
    assert "marker absent" in err[1] and len(sleeps) == 2
    assert (surv, lost) == ([0], [1])
    out = _run(_collective_span, tmp_path / "e")
    assert out["metrics"]["counters"]["health.dcn_stall"] == 1.0
    assert out["result"] == ([], [])


# ---- interop: one directory, both packages --------------------------------------------


def test_jax_and_port_monitors_share_a_directory(tmp_path):
    """A JAX monitor (host 0) and a port monitor (host 1) of a 3-host
    fleet on one directory and one clock: each sees the other's beats, the
    other's silence, and the other's tombstones."""
    clock = Clock()
    d = str(tmp_path)
    j = jhealth.HealthMonitor(d, host_id=0, num_hosts=3, timeout_s=1.0,
                              misses=2, clock=clock, start_thread=False)
    t = thealth.HealthMonitor(d, host_id=1, num_hosts=3, timeout_s=1.0,
                              misses=2, clock=clock, start_thread=False)
    j.start()
    t.start()
    try:
        assert j.poll() == [] and t.poll() == []
        assert j._seen_seq[1] == 1 and t._seen_seq[0] == 1
        clock.t = 0.8
        j.beat(step=4)
        t.beat(step=4)
        assert j.poll() == [] and t.poll() == []
        assert j._seen_seq[1] == t._seen_seq[0] == 2
        # the JAX host goes silent: the port declares it lost
        clock.t = 1.9
        t.beat()
        assert t.poll() == [] and j.poll() == []
        clock.t = 2.0
        t.beat()
        assert t.poll() == [0] and t.lost() == [0] and t.peer_lost
        assert j.poll() == [] and not j.peer_lost
        # tombstones cross too: the JAX host kills the phantom host 2, the
        # port host sees it; the port host kills host 0, the JAX host...
        j.simulate_loss(2)
        assert t.poll() == [2] and t.lost() == [0, 2]
        # ...never reads its own tombstone, but a restart clears it
        t.simulate_loss(0)
        assert os.path.exists(os.path.join(d, "host0.dead"))
        j.stop()
        jhealth.HealthMonitor(d, host_id=0, num_hosts=3, clock=clock,
                              start_thread=False).start().stop()
        assert not os.path.exists(os.path.join(d, "host0.dead"))
        keys = {n: sorted(json.load(open(os.path.join(d, n))))
                for n in ("host0.hb", "host1.hb", "host2.dead")}
        assert keys == {"host0.hb": ["host", "seq", "step", "ts"],
                        "host1.hb": ["host", "seq", "step", "ts"],
                        "host2.dead": ["by", "host"]}
    finally:
        j.stop()
        t.stop()


def test_a_port_rejoin_is_validated_by_a_jax_coordinator(tmp_path):
    """The rejoin protocol across packages: the port host (1) is lost on
    the JAX coordinator, restarts, announces itself and beats; the JAX
    coordinator validates and readmits it, and both meet at the regrow
    rendezvous."""
    clock = Clock()
    d = str(tmp_path)
    j = jhealth.HealthMonitor(d, host_id=0, num_hosts=2, timeout_s=1.0,
                              misses=2, clock=clock,
                              start_thread=False).start()
    try:
        t = thealth.HealthMonitor(d, host_id=1, num_hosts=2, clock=clock,
                                  start_thread=False).start()
        j.poll()
        j.simulate_loss(1)
        j.acknowledge()
        t.stop()
        t2 = thealth.HealthMonitor(d, host_id=1, num_hosts=2, clock=clock,
                                   start_thread=False)
        t2._seq = 100           # the new incarnation's own seq stream
        t2.start()
        assert not os.path.exists(os.path.join(d, "host1.dead"))
        t2.announce_rejoin(j.generation + 1)
        assert sorted(j.pending_rejoins()) == [1]
        assert j.validate_rejoin(1, j.generation + 1)["host"] == 1
        j.readmit(1)
        j.generation += 1
        assert j.survivors() == [0, 1]
        thealth._write_rendezvous_marker(d, j.generation, 1)
        assert jhealth.rendezvous(d, 0, [0, 1], generation=j.generation,
                                  timeout_s=1.0, clock=clock,
                                  sleep=clock.sleep) == [0, 1]
        t2.stop()
    finally:
        j.stop()


# ---- the port's watchdog thread --------------------------------------------------------


def test_watchdog_thread_beats_and_detects(tmp_path):
    """The real thread writes heartbeats on its own and sees a tombstoned
    peer without a manual poll; ``stop`` joins it and deactivates the
    monitor."""
    mon = thealth.HealthMonitor(str(tmp_path), host_id=0, num_hosts=2,
                                interval_s=0.02, timeout_s=5.0,
                                misses=2).start()
    try:
        assert thealth.active_monitor() is mon
        deadline = time.monotonic() + 5.0
        seq0 = json.load(open(tmp_path / "host0.hb"))["seq"]
        while json.load(open(tmp_path / "host0.hb"))["seq"] == seq0:
            assert time.monotonic() < deadline, "the watchdog never beat"
            time.sleep(0.01)
        (tmp_path / "host1.dead").write_text("{}")
        while not mon.peer_lost:
            assert time.monotonic() < deadline, "no tombstone seen"
            time.sleep(0.01)
        assert mon.lost() == [1]
    finally:
        mon.stop()
    assert thealth.active_monitor() is None and mon._thread is None


def test_watchdog_detects_a_silent_peer_by_staleness(tmp_path):
    """A second monitor beats on its own thread, then stops: the first's
    watchdog declares it lost within timeout + misses x interval of its
    last beat, by staleness (no tombstone)."""
    interval, timeout, misses = 0.02, 0.1, 2
    a = thealth.HealthMonitor(str(tmp_path), host_id=0, num_hosts=2,
                              interval_s=interval, timeout_s=timeout,
                              misses=misses).start()
    b = thealth.HealthMonitor(str(tmp_path), host_id=1, num_hosts=2,
                              interval_s=interval, timeout_s=timeout,
                              misses=misses)
    b._start_thread = True
    b.start()
    try:
        time.sleep(5 * interval)
        assert not a.peer_lost
        b.stop()
        t_stop = time.monotonic()
        deadline = t_stop + 5.0
        while not a.peer_lost:
            assert time.monotonic() < deadline, "the silence went unseen"
            time.sleep(0.005)
        assert a.lost() == [1]
        assert not (tmp_path / "host1.dead").exists()
    finally:
        a.stop()
        b.stop()
