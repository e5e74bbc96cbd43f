"""Cluster health: per-host heartbeats, a peer-loss watchdog, rendezvous
(the JAX package's ``resilience/health.py``).

A multi-host run dies if any host drops out: its collectives hang until a
connect timeout. This module makes a partial failure an observable,
recoverable event:

- :class:`HealthMonitor`: each host writes a small heartbeat file into a
  shared directory from a watchdog thread (every ``interval_s``) and
  watches its peers' files. Liveness is stamped with the LOCAL monotonic
  clock when a new heartbeat is seen (never the peer's wall clock), so
  clock skew between hosts cannot fake a death. A peer whose heartbeat
  stays stale past ``timeout_s`` for ``misses`` consecutive polls, or that
  left a tombstone, is declared lost: a ``peer_lost`` obs event fires and
  :attr:`HealthMonitor.peer_lost` flips. The train loops and the serve
  loop read that flag once per step (an ``Event`` read: no device work,
  no system call).
- Piggybacked liveness: a completed cross-host collective proves every
  peer was alive moments ago, so :func:`collective_span` refreshes every
  peer's last-seen stamp; the file heartbeat covers the gaps.
- :func:`rendezvous`: survivors agree on the membership after a loss.
  Each writes a marker into a generation-numbered directory and polls,
  with exponential backoff, until every expected host checked in or the
  timeout expires (``clock`` and ``sleep`` are injectable).
- The rejoin protocol (the grow-back direction): a recovered host
  publishes a generation-stamped rejoin marker beside its heartbeat
  (:meth:`HealthMonitor.announce_rejoin`); the coordinator proves its
  liveness with ``misses`` consecutive fresh heartbeat reads
  (:meth:`HealthMonitor.validate_rejoin`, under the budgeted retry of
  :func:`attempt_rejoin`) and re-admits it (:meth:`HealthMonitor.readmit`).
  A refused rejoin raises :class:`RejoinRefused` and leaves the membership
  as it was.
- :func:`collective_span`: the DCN-stall probe. It wraps a cross-host
  collective in the ``dcn.collective`` span and emits a ``dcn_stall``
  event and counter when the collective takes longer than the threshold.

Every marker (heartbeats, tombstones, rejoin markers, rendezvous
check-ins) is published tmp-then-rename and read tolerantly: a reader
racing a writer sees the previous marker or nothing, never a torn file.
The file names and JSON keys are the JAX package's, so a JAX monitor and
a port monitor can share one directory.

Host-side stdlib only: no torch, no device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterable

from cst_captioning_tpu_torch import obs


class PeerLost(RuntimeError):
    """Raised by a train loop after a peer-loss drain and save. ``hosts``
    names the lost host ids."""

    def __init__(self, hosts: Iterable[int], message: str):
        self.hosts = sorted(int(h) for h in hosts)
        super().__init__(message)


class RendezvousTimeout(RuntimeError):
    """A rendezvous expired before every expected host checked in."""


class RejoinRefused(RuntimeError):
    """A host's rejoin was refused (marker absent or corrupt, a stale
    generation, no fresh heartbeats). The membership stays as it was."""


class HostRejoin(RuntimeError):
    """Raised by a train loop after a validated rejoin drained the
    pipeline at a batch boundary. ``host`` names the rejoiner."""

    def __init__(self, host: int, message: str):
        self.host = int(host)
        super().__init__(message)


# the DCN-stall probe's default threshold; a run sets train.dcn_stall_s
# through set_dcn_stall_threshold
_DCN_STALL_S = 2.0


def set_dcn_stall_threshold(seconds: float) -> None:
    global _DCN_STALL_S
    _DCN_STALL_S = float(seconds)


def _publish_json(path: str, rec: dict) -> None:
    """Atomic marker publish: write a sibling tmp file, then rename it into
    place, so a reader sees the previous marker or nothing."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


@contextmanager
def collective_span(op: str, stall_threshold_s: float | None = None):
    """The ``dcn.collective`` span and stall probe around one cross-host
    collective: feeds ``dcn.collective_seconds``, and past the threshold
    emits a ``dcn_stall`` event and counts ``health.dcn_stall``. A
    completed collective refreshes every peer's liveness on the active
    monitor."""
    t0 = time.perf_counter()
    with obs.span("dcn.collective", op=op):
        yield
    dur = time.perf_counter() - t0
    obs.histogram("dcn.collective_seconds").observe(dur)
    threshold = _DCN_STALL_S if stall_threshold_s is None else stall_threshold_s
    if dur > threshold:
        obs.counter("health.dcn_stall").inc()
        obs.event("dcn_stall", op=op, dur_s=round(dur, 6),
                  threshold_s=threshold)
    mon = _ACTIVE
    if mon is not None:
        mon.record_collective()


class HealthMonitor:
    """File-heartbeat cluster monitor with a watchdog thread.

    One instance per host. ``num_hosts`` may exceed the real process count
    (simulated hosts for chaos runs, killed only through
    :meth:`simulate_loss`): a peer that never beat is not declared lost by
    staleness alone, only one that went silent after being seen, or one
    with a tombstone. ``clock`` is injectable (``time.monotonic`` by
    default), so loss detection is testable without sleeping.
    """

    def __init__(
        self,
        dir: str,
        host_id: int = 0,
        num_hosts: int = 1,
        interval_s: float = 0.5,
        timeout_s: float = 5.0,
        misses: int = 2,
        log: Callable[..., None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        start_thread: bool = True,
    ):
        if num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(
                f"host_id {host_id} not in [0, num_hosts={num_hosts})")
        if interval_s <= 0 or timeout_s <= 0 or misses < 1:
            raise ValueError(
                "health knobs out of range: interval_s > 0, timeout_s > 0, "
                f"misses >= 1 required (got {interval_s}, {timeout_s}, "
                f"{misses})")
        self.dir = dir
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.misses = misses
        self.log = log or (lambda event, **fields: None)
        self.clock = clock
        self._start_thread = start_thread
        self.peers: set[int] = set(range(num_hosts)) - {host_id}
        self.lost_hosts: set[int] = set()
        # the membership generation, bumped on every shrink or regrow;
        # rejoin markers carry generation + 1, so one from an earlier round
        # is refused as stale
        self.generation = 0
        self._seq = 0
        self._step = 0
        self._seen_seq: dict[int, int] = {}
        self._last_seen: dict[int, float] = {}
        self._strikes: dict[int, int] = {}
        self._loss_event = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        os.makedirs(dir, exist_ok=True)

    # ---- lifecycle ----------------------------------------------------------

    def start(self) -> "HealthMonitor":
        global _ACTIVE
        now = self.clock()
        with self._lock:
            # peers have a full timeout from the start to appear
            for p in self.peers:
                self._last_seen.setdefault(p, now)
        # a restarted host is alive: its own tombstone, left by the
        # survivors of its previous incarnation, is stale
        try:
            os.unlink(self._tombstone(self.host_id))
        except FileNotFoundError:
            pass
        self.beat()
        _ACTIVE = self
        if self._start_thread and self._thread is None:
            self._thread = threading.Thread(
                target=self._watchdog, daemon=True, name="health-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        global _ACTIVE
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "HealthMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _watchdog(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()
            self.poll()

    # ---- heartbeats ---------------------------------------------------------

    def _hb_path(self, host: int) -> str:
        return os.path.join(self.dir, f"host{host}.hb")

    def _tombstone(self, host: int) -> str:
        return os.path.join(self.dir, f"host{host}.dead")

    def note_step(self, step: int) -> None:
        """Record train progress for the next heartbeat: an attribute
        store, free once per step."""
        self._step = int(step)

    def beat(self, step: int | None = None) -> None:
        """Write this host's heartbeat file (atomic replace)."""
        if step is not None:
            self._step = int(step)
        with self._lock:
            self._seq += 1
            # wall clock: the payload is read by people and other hosts
            rec = {"host": self.host_id, "seq": self._seq,
                   "step": self._step, "ts": time.time()}
        try:
            _publish_json(self._hb_path(self.host_id), rec)
        except OSError as e:
            # a missed beat is survivable (peers debounce); losing the run
            # to a transient shared-filesystem error is not
            self.log("heartbeat_write_failed", error=type(e).__name__,
                     detail=str(e))
            return
        obs.counter("health.heartbeats").inc()

    def _read_hb(self, host: int) -> dict | None:
        try:
            with open(self._hb_path(host), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None  # absent, or torn mid-replace: no news
        return rec if isinstance(rec, dict) else None

    # ---- peer-loss detection ------------------------------------------------

    def poll(self, now: float | None = None) -> list[int]:
        """One watchdog pass: refresh last-seen stamps from the peers'
        heartbeat files, detect tombstones and stale peers, set the gauges.
        Returns the hosts this pass declared lost."""
        now = self.clock() if now is None else now
        newly_lost: list[int] = []
        max_age = 0.0
        with self._lock:
            peers = sorted(self.peers - self.lost_hosts)
        for p in peers:
            if os.path.exists(self._tombstone(p)):
                if self._mark_lost(p, reason="tombstone"):
                    newly_lost.append(p)
                continue
            rec = self._read_hb(p)
            with self._lock:
                if rec is not None and rec.get("seq") != self._seen_seq.get(p):
                    # a new heartbeat: stamp its receipt with our clock
                    self._seen_seq[p] = rec.get("seq")
                    self._last_seen[p] = now
                    self._strikes[p] = 0
                    age = 0.0
                else:
                    age = now - self._last_seen.get(p, now)
            max_age = max(max_age, age)
            if age > self.timeout_s:
                with self._lock:
                    self._strikes[p] = self._strikes.get(p, 0) + 1
                    strikes = self._strikes[p]
                if strikes >= self.misses and self._seen_seq.get(p) is not None:
                    if self._mark_lost(p, reason="heartbeat_timeout",
                                       age_s=round(age, 3)):
                        newly_lost.append(p)
        obs.gauge("health.peers_alive").set(
            float(len(self.survivors()) - 1))
        obs.gauge("health.peer_age_max_s").set(max_age)
        return newly_lost

    def _mark_lost(self, host: int, **info) -> bool:
        with self._lock:
            if host in self.lost_hosts or host not in self.peers:
                return False
            self.lost_hosts.add(host)
        obs.counter("health.peer_lost").inc()
        obs.event("peer_lost", host=host, **info)
        self.log("peer_lost", host=host, **info)
        self._loss_event.set()
        return True

    def record_collective(self) -> None:
        """A cross-host collective completed, so every peer not lost took
        part: refresh their last-seen stamps (the piggybacked heartbeat)."""
        now = self.clock()
        with self._lock:
            for p in self.peers - self.lost_hosts:
                self._last_seen[p] = now
                self._strikes[p] = 0

    def simulate_loss(self, host: int) -> None:
        """Chaos hook (the ``partial_preempt`` fault): kill a (possibly
        simulated) peer now: a tombstone on disk for other processes, and
        a synchronous mark for deterministic single-process runs."""
        if host == self.host_id:
            raise ValueError(
                f"partial_preempt host {host} is this host; use the "
                "'preempt' fault kind for whole-process preemption")
        if host not in self.peers:
            raise ValueError(
                f"partial_preempt host {host} not a peer of host "
                f"{self.host_id} (peers: {sorted(self.peers)})")
        try:
            _publish_json(self._tombstone(host),
                          {"host": host, "by": self.host_id})
        except OSError as e:
            # the mark below still lands; the peers of a real fleet fall
            # back to heartbeat-timeout detection
            self.log("tombstone_write_failed", host=host,
                     error=type(e).__name__, detail=str(e))
        self._mark_lost(host, reason="partial_preempt")

    def simulate_recovery(self, host: int, flaky: bool = False) -> None:
        """Chaos hook (the ``host_rejoin`` fault): a lost, possibly
        simulated, peer recovers now. On its behalf, as a restarted process
        does in :meth:`start` and :meth:`announce_rejoin`: clear its
        tombstone, publish the new incarnation's first heartbeat (a fresh
        seq), write a rejoin marker stamped with the next generation and,
        unless ``flaky``, check into the regrow rendezvous. A flaky
        rejoiner announces itself and dies before the rendezvous, so the
        survivors' regrow rendezvous times out."""
        if host == self.host_id:
            raise ValueError(
                f"host_rejoin host {host} is this host; it never left")
        with self._lock:
            if host not in self.lost_hosts:
                raise ValueError(
                    f"host_rejoin host {host} is not a lost host "
                    f"(lost: {sorted(self.lost_hosts)})")
            fresh_seq = int(self._seen_seq.get(host) or 0) + 1
        try:
            os.unlink(self._tombstone(host))
        except FileNotFoundError:
            pass
        gen = int(self.generation) + 1
        _publish_json(self._hb_path(host), {
            "host": host, "seq": fresh_seq, "step": 0, "ts": time.time()})
        self.announce_rejoin(gen, host=host)
        if not flaky:
            _write_rendezvous_marker(self.dir, gen, host)
        self.log("host_rejoin_simulated", host=host, generation=gen,
                 flaky=flaky)

    # ---- rejoin (grow-back) -------------------------------------------------

    def _rejoin_path(self, host: int) -> str:
        return os.path.join(self.dir, f"host{host}.rejoin")

    def announce_rejoin(self, generation: int, host: int | None = None) -> None:
        """Publish a generation-stamped rejoin marker beside the heartbeat.
        A recovered host calls this with the generation it wants to join
        (the current one + 1)."""
        host = self.host_id if host is None else int(host)
        rec = {"host": host, "generation": int(generation),
               "ts": time.time()}
        try:
            _publish_json(self._rejoin_path(host), rec)
        except OSError as e:
            self.log("rejoin_write_failed", host=host,
                     error=type(e).__name__, detail=str(e))
            return
        obs.counter("health.rejoin_announced").inc()

    def read_rejoin(self, host: int) -> dict | None:
        """A host's rejoin marker, or None when absent or torn."""
        try:
            with open(self._rejoin_path(host), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def pending_rejoins(self) -> dict[int, dict]:
        """Lost hosts with a readable rejoin marker, by host id."""
        out: dict[int, dict] = {}
        for h in self.lost():
            rec = self.read_rejoin(h)
            if rec is not None:
                out[h] = rec
        return out

    def clear_rejoin(self, host: int) -> None:
        """Consume a rejoin marker, after an admission or a refusal."""
        try:
            os.unlink(self._rejoin_path(host))
        except FileNotFoundError:
            pass

    def validate_rejoin(
        self,
        host: int,
        generation: int,
        sleep: Callable[[float], None] | None = None,
    ) -> dict:
        """The coordinator's admission check for one announced rejoiner.

        Read-only (only :meth:`readmit` changes the membership): the marker
        must parse and carry exactly ``generation``, and ``misses``
        consecutive heartbeat reads must each parse with a seq other than
        the last one seen before the loss (a restarted process begins a new
        seq stream; the dead incarnation's file never passes). ``sleep``
        spaces the reads by ``interval_s``. Raises :class:`RejoinRefused`;
        returns the marker on success.
        """
        rec = self.read_rejoin(host)
        if rec is None:
            raise RejoinRefused(
                f"host {host}: rejoin marker absent or unreadable")
        marker_gen = rec.get("generation")
        if marker_gen != int(generation):
            raise RejoinRefused(
                f"host {host}: stale rejoin generation {marker_gen!r} "
                f"(current regrow generation is {int(generation)})")
        with self._lock:
            if host not in self.lost_hosts:
                raise RejoinRefused(
                    f"host {host} is not in the lost set "
                    f"({sorted(self.lost_hosts)}); nothing to re-admit")
            stale_seq = self._seen_seq.get(host)
        for i in range(self.misses):
            if i and sleep is not None:
                sleep(self.interval_s)
            hb = self._read_hb(host)
            if hb is None:
                raise RejoinRefused(
                    f"host {host}: no readable heartbeat on poll "
                    f"{i + 1}/{self.misses} — announced, then went silent")
            if hb.get("seq") == stale_seq:
                raise RejoinRefused(
                    f"host {host}: heartbeat seq {stale_seq} predates the "
                    f"loss (poll {i + 1}/{self.misses}) — the dead "
                    "incarnation's file, not a recovery")
        return rec

    def readmit(self, host: int) -> None:
        """Admit a validated rejoiner back into the membership: clear the
        lost record, re-arm liveness tracking with a fresh grace stamp, and
        consume the tombstone, rejoin marker and recovery heartbeat. The
        host is then in the never-seen state (tombstone-only detection)
        until its new incarnation's beats are observed."""
        now = self.clock()
        with self._lock:
            if host not in self.lost_hosts:
                raise ValueError(f"host {host} is not lost; nothing to readmit")
            self.lost_hosts.discard(host)
            self.peers.add(host)
            self._seen_seq.pop(host, None)
            self._strikes[host] = 0
            self._last_seen[host] = now
        for path in (self._tombstone(host), self._rejoin_path(host),
                     self._hb_path(host)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        obs.counter("health.peer_readmitted").inc()
        obs.event("peer_readmitted", host=host)
        self.log("peer_readmitted", host=host)

    # ---- membership ---------------------------------------------------------

    @property
    def peer_lost(self) -> bool:
        """True while a peer loss is unacknowledged: a lock-free ``Event``
        read, the loops' once-per-step poll."""
        return self._loss_event.is_set()

    def lost(self) -> list[int]:
        with self._lock:
            return sorted(self.lost_hosts)

    def survivors(self) -> list[int]:
        with self._lock:
            return sorted(({self.host_id} | self.peers) - self.lost_hosts)

    def acknowledge(self) -> None:
        """Clear the pending-loss flag; the lost set stays, so a host comes
        back only through the validated rejoin path."""
        self._loss_event.clear()

    def set_membership(self, hosts: Iterable[int]) -> None:
        """Adopt the membership a rendezvous agreed on (the lost record is
        kept for reporting)."""
        hosts = set(int(h) for h in hosts)
        with self._lock:
            self.peers = hosts - {self.host_id}


_ACTIVE: HealthMonitor | None = None


def active_monitor() -> HealthMonitor | None:
    return _ACTIVE


def simulate_peer_loss(host: int) -> None:
    """The ``partial_preempt`` fault's entry point."""
    mon = _ACTIVE
    if mon is None:
        raise RuntimeError(
            "partial_preempt fault fired with no active HealthMonitor — "
            "enable train.health (the fault models a peer loss the monitor "
            "must detect)")
    mon.simulate_loss(host)


def simulate_rejoin(host: int, flaky: bool = False) -> None:
    """The ``host_rejoin`` (``flaky=True``: ``host_rejoin_flaky``) fault's
    entry point."""
    mon = _ACTIVE
    if mon is None:
        raise RuntimeError(
            "host_rejoin fault fired with no active HealthMonitor — enable "
            "train.health (the fault models a recovered host the monitor "
            "must re-admit)")
    mon.simulate_recovery(host, flaky=flaky)


def attempt_rejoin(
    monitor: HealthMonitor,
    host: int,
    generation: int,
    policy=None,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Validate one announced rejoiner under a budgeted retry (its first
    heartbeat may land a beat after its marker). Returns the marker; when
    the policy is spent the last :class:`RejoinRefused` propagates and the
    membership stays as it was. Counts ``resilience.regrow.attempts`` and
    ``resilience.regrow.refused``."""
    from cst_captioning_tpu_torch.resilience.retry import (
        RetryPolicy,
        retry_call,
    )

    obs.counter("resilience.regrow.attempts").inc()
    if policy is None:
        policy = RetryPolicy(
            max_attempts=2,
            base_delay=monitor.interval_s,
            max_delay=monitor.timeout_s,
            budget=monitor.timeout_s,
            retry_on=(RejoinRefused, OSError),
        )

    def on_retry(info: dict) -> None:
        monitor.log("rejoin_retry", host=host, attempt=info["attempt"],
                    delay=info["delay"], error=info["error"])

    try:
        return retry_call(monitor.validate_rejoin, host, generation,
                          policy=policy, on_retry=on_retry, sleep=sleep)
    except RejoinRefused:
        obs.counter("resilience.regrow.refused").inc()
        raise


def _write_rendezvous_marker(dir: str, generation: int, host_id: int) -> str:
    """Check one host into a generation directory (atomic publish) ->
    the directory."""
    rdir = os.path.join(dir, f"rendezvous_{int(generation):04d}")
    os.makedirs(rdir, exist_ok=True)
    _publish_json(os.path.join(rdir, f"host{host_id}.json"),
                  {"host": host_id, "ts": time.time()})
    return rdir


def rendezvous(
    dir: str,
    host_id: int,
    hosts: Iterable[int],
    generation: int = 0,
    timeout_s: float = 30.0,
    poll_s: float = 0.05,
    backoff: float = 1.5,
    max_poll_s: float = 1.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> list[int]:
    """Block until every host of ``hosts`` checked into
    ``<dir>/rendezvous_<generation>/``, polling with exponential backoff.
    Returns the sorted membership; raises :class:`RendezvousTimeout`
    naming the missing hosts."""
    expected = sorted(int(h) for h in hosts)
    rdir = _write_rendezvous_marker(dir, generation, host_id)
    t0 = clock()
    delay = poll_s
    while True:
        present = [h for h in expected
                   if os.path.exists(os.path.join(rdir, f"host{h}.json"))]
        if len(present) == len(expected):
            obs.event("rendezvous", generation=generation, hosts=present)
            return present
        if clock() - t0 > timeout_s:
            missing = sorted(set(expected) - set(present))
            raise RendezvousTimeout(
                f"rendezvous generation {generation} timed out after "
                f"{timeout_s}s: hosts {missing} never checked in "
                f"(present: {present})")
        sleep(delay)
        delay = min(delay * backoff, max_poll_s)
