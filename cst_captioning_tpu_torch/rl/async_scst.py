"""Decoupled actor/learner SCST (the JAX package's ``rl/async_scst.py``).

``train.rl_topology="decoupled"``: actors decode rollout batches into a
:class:`RolloutRing` (sampled tokens, their logprobs and the greedy lane,
``rl.rollout_depth`` batches deep) and a learner consumes the oldest entry
once the ring is full, with the sync trainer's reward, advantage and
REINFORCE update. A rollout decoded under parameters more than
``rl.staleness_bound`` learner updates old at consumption is DROPPED and
recounted: decoded again under the current parameters from the entry's own
seed and noise, so the drop and recount sequence is the same run to run.

Layouts (``mesh=``, a ``train.mesh.DataMesh``):

- ``None`` or a world of 1: one device, one stream. Actor and learner share
  the device; the learner updates ``state.model`` in place, and the ring
  stays correct because each decode is launched on the stream before the
  updates it must not see. The actor's "broadcast" (``rl.actor.broadcast``)
  is a rebind of the learner's model.
- Several ranks (one process a device, ``train/multihost.py``):
  ``parallel.submesh.plan_submesh`` splits them into actor ranks (first)
  and learner ranks, where the JAX package splits one process's devices.
  Every rank takes the GLOBAL batch and runs the same schedule; the roles
  decide the work. Actor ranks refresh their parameters from the learner
  root (``rl.actor.broadcast``: one broadcast a dtype over the group of
  the learner root and the live actors), decode their rows of batch ``j``
  (``rl.actor.decode``; the noise of their global rows, so any actor count
  draws each row's noise) and hand tokens, logprobs and the greedy lane to
  the learner ranks that own those rows (``train.multihost.post_send``,
  tagged with the batch and the actor-set generation). Learner ranks keep
  the ring of their rows and consume it (``rl.learner.step``), the update
  all-reducing over the learner submesh (one learner: the one-device
  update). Decode ``j`` sees exactly the parameter version the one-device
  schedule gives it, ``max(0, j - depth + 1)`` in steady state: the
  schedule is computed alike on every rank, and the broadcast sends the
  learner's state at that point. A step's metrics go from the learners to
  every rank (the loss is global; the reward, baseline and advantage
  means are combined over the learners' rows), so every rank's trainer
  sees the same steps. Drops are recounted on the learner ranks, each its
  own rows, from the entry's seed under the current parameters; the JAX
  package recounts on the actor submesh, but the row-keyed noise gives the
  same tokens either way. Every rank leaves :meth:`train_epoch` holding
  the learner's state (parameters, Adam moments, step and seed, broadcast
  from the learner root): the JAX split's "pushed back to the full mesh on
  return".
- A ``('data', 'mp')`` grid (``train.mesh.GridMesh``): ``plan_submesh``
  splits it along its data rows, and each mp column runs the split above
  over its own data ranks (the plan's ``column``), with the handoff and
  the broadcast inside the column. The ranks of an ``'mp'`` row are
  replicas, as in the sync trainer: the learners' reduced gradients are
  broadcast over the row (``row=`` of the update), and the exchanges that
  gather over the world keep this column's ranks. A preemption or rejoin
  of one rank refuses the 2-D plan (``shrink_actors``, ``grow_actors``),
  as in the JAX package.
- Several virtual ranks: a mesh without a process group and a world above
  1 plans the split by the same rules but runs every role in this process
  (every row decoded and updated here). Its schedule, events and ledgers
  are the split's and its tokens and update the one-device run's: the
  reference a split run is held to.

STRICT mode (``strict=True``, or ``rollout_depth=1`` with
``staleness_bound=0``) replays the sync loop's schedule on the shared plan
(every rank both roles, each its own rows, the data-parallel update):
depth 2 is :meth:`SCSTTrainer.train_epoch`'s pipeline (decode(i) one
update stale, update(i-1) after decode(i)), depth 1 its ``pipelined=False``
loop, and the tokens, metrics and parameters equal the sync loop's bit for
bit.

Seeds. ``train_epoch`` takes the port's ``seeds(j)`` and optional
``noise_fns(j)`` where the JAX loop takes a key it splits per batch; a ring
entry stores its batch's integer seed and its index ``j``, and a recount
decodes from both again.

Preemption. :func:`request_actor_preempt` queues a preemption the epoch
services at its next batch boundary: the actor rank is shed
(``shrink_actors``) and the survivors decode on, or, when none survives,
the epoch falls back to the sync schedule on the learners
(``rl_actor_fallback_sync``: a schedule the seeded fault plan asks for, not
an error path). :func:`request_actor_rejoin` regrows the actor set from the
initial plan (``grow_actors``, ``rl_actor_regrown``). Either way the
in-flight entries are recounted in order on the learners. A shed rank
stays alive and idle: it still takes part in every world-level exchange,
group creation and broadcast. Across ranks every boundary starts with one
exchange over the world: the batch stops if any rank's ``should_stop`` is
set, and the pending requests are those of the lowest rank holding any (a
plan run on every rank fires on each and counts once; a request made on
one rank lands on every rank). Drain: ``should_stop`` persists the
in-flight ring, gathered from the learners, into ``seam_sink`` (the
trainer's ``seam.npz`` ring layout) and a resume replays those tokens;
strict drains resume bit for bit.

Observability (the JAX names): the ``rl.actor.broadcast``,
``rl.actor.decode`` and ``rl.learner.step`` spans, the
``rl.actor.batches``, ``rl.learner.steps``, ``rl.staleness.dropped``,
``rl.actor.preempted`` and ``rl.actor.rejoined`` counters, the
``rl.staleness`` histogram and the host-observed ``rl.actor.occupancy``
and ``rl.learner.occupancy`` gauges (across ranks, the mean over the
ranks that held the role).

Chaos: the loop visits ``rl.actor.step`` once a batch while it has not
fallen back to the sync schedule, before it services rejoins and
preemptions, so a fault plan's ``actor_preempt`` lands at that batch's
boundary (``resilience/chaos.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import RLConfig
from cst_captioning_tpu_torch.decoding.fused import fused_decode
from cst_captioning_tpu_torch.decoding.sample import sample_decode
from cst_captioning_tpu_torch.parallel.submesh import (
    grow_actors,
    plan_submesh,
    shared_plan,
    shrink_actors,
)
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.rl.scst import SCSTTrainer, _host_copy
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import mp_row, replicate
from cst_captioning_tpu_torch.train.state import TrainState

# pending actor preemptions and rejoins; the running epoch services them
# at its next batch boundary
_PREEMPT_REQUESTS: list[int] = []
_REJOIN_REQUESTS: list[int] = []

# a step's means that combine over the learners' rows, weighted by their
# valid rows (every other metric is the learner root's)
_ROW_MEANS = ("reward_mean", "baseline_mean", "advantage_mean")


def request_actor_preempt(slice_index=None) -> None:
    """Mark one actor rank (by index into the current actor submesh) as
    preempted; the running :class:`AsyncSCSTTrainer` epoch services it at
    its next batch boundary."""
    _PREEMPT_REQUESTS.append(0 if slice_index is None else int(slice_index))


def request_actor_rejoin(slice_index=None) -> None:
    """Inverse of :func:`request_actor_preempt`: re-admit one shed actor
    rank (by index into the INITIAL actor submesh, so a preempt and a
    rejoin addressing the same index round-trip the same rank)."""
    _REJOIN_REQUESTS.append(0 if slice_index is None else int(slice_index))


def _covered_s(windows) -> float:
    """Seconds covered by the union of (start, end) windows."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(windows):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _take(x, rows):
    """Rows ``rows`` (a slice) of a batch field: a dict of tensors, a list,
    an array, or None."""
    if x is None or rows == slice(None):
        return x
    if isinstance(x, dict):
        return {k: v[rows] for k, v in x.items()}
    return x[rows]


def _sliced(noise_fn, rows):
    """A ``noise_fn(t) -> [K, B, V]`` of the global batch, cut to ``rows``."""
    if noise_fn is None or rows == slice(None):
        return noise_fn
    return lambda t: noise_fn(t)[:, rows]


def make_actor_decode(model, num_rollouts: int, temperature: float = 1.0,
                      max_len: int | None = None, with_greedy: bool = True,
                      mesh=None):
    """-> decode(model, feats, masks, seed, noise_fn=None) -> (greedy
    [B, T] or None, samples [K, B, T], sample logprobs [K, B, T]).

    The same calls as ``make_rl_decode`` (``fused_decode`` with the greedy
    lane, ``sample_decode`` without), so strict mode's tokens equal the
    sync loop's; this decode keeps the sampled lanes' logprobs. ``mesh``
    (an actor or learner submesh) places the given rows in the global
    batch: they start at ``mesh.rank * B``, and their noise is that of
    those global rows."""
    del model  # the decode call names the model that holds the params

    def decode(model, feats, masks, seed: int, noise_fn=None):
        B = next(iter(feats.values())).shape[0]
        offset = mesh.rank * B if mesh is not None else 0
        if with_greedy:
            greedy, _, samples, lps = fused_decode(
                model, feats, masks, seed, num_rollouts=num_rollouts,
                temperature=temperature, max_len=max_len, noise_fn=noise_fn,
                row_offset=offset)
            return greedy, samples, lps
        samples, lps = sample_decode(
            model, feats, masks, seed, num_rollouts=num_rollouts,
            temperature=temperature, max_len=max_len, noise_fn=noise_fn,
            row_offset=offset)
        return None, samples, lps

    return decode


class RolloutRing:
    """Ring of decoded rollout batches on the learner's device (the
    actor -> learner handoff; depth 2 is the double buffer).

    Storage is three tensors allocated at the first write: sampled tokens
    [D, K, B, T], their logprobs [D, K, B, T] and, with a greedy lane,
    [D, B, T], written a slot at a time with ``copy_``, so the ring holds
    ``depth`` batches whatever streams through it. Each entry's host
    metadata (seed, version, batch, video ids) waits in a deque. A read
    returns views of a slot: the next write into that slot is ordered
    after every use of the views on the device's stream. An entry pushed
    with :meth:`push_pending` lands its tensors at its first read (a
    handoff still in flight); one without a landing holds none (a rank
    with no rows of it: the schedule's metadata alone).
    """

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self._tokens = None      # [D, K, B, T] sampled tokens
        self._lps = None         # [D, K, B, T] sample logprobs
        self._greedy = None      # [D, B, T] greedy baseline (optional)
        self._meta: deque = deque()
        self._slot = 0

    def __len__(self) -> int:
        return len(self._meta)

    def _alloc(self, like: torch.Tensor, device) -> torch.Tensor:
        return torch.empty((self.depth,) + tuple(like.shape),
                           dtype=like.dtype, device=device)

    def _next_slot(self) -> int:
        slot = self._slot
        self._slot = (slot + 1) % self.depth
        return slot

    def _write(self, slot, greedy, samples, lps, device=None) -> None:
        if self._tokens is None:
            dev = samples.device if device is None else device
            self._tokens = self._alloc(samples, dev)
            self._lps = self._alloc(lps, dev)
            if greedy is not None:
                self._greedy = self._alloc(greedy, dev)
        self._tokens[slot].copy_(samples, non_blocking=True)
        self._lps[slot].copy_(lps, non_blocking=True)
        if greedy is not None:
            self._greedy[slot].copy_(greedy, non_blocking=True)

    def push(self, greedy, samples, lps, device=None, **meta) -> None:
        """Write one decoded batch into the next slot and queue its
        metadata. Batch shapes are constant across an epoch (the
        video-mode batcher wrap-pads). ``device`` (default the samples')
        holds the ring; host tensors are copied onto it."""
        slot = self._next_slot()
        self._write(slot, greedy, samples, lps, device)
        self._meta.append(dict(slot=slot, **meta))

    def push_pending(self, landing, **meta) -> None:
        """Queue an entry whose tensors are in flight: ``landing()`` ->
        (greedy, samples, lps) lands them into its slot at the first read.
        ``landing`` None: this rank holds none of its rows."""
        self._meta.append(dict(slot=self._next_slot(), landing=landing,
                               **meta))

    def _read(self, meta):
        landing = meta.pop("landing", None)
        if landing is not None:
            self._write(meta["slot"], *landing())
        if self._tokens is None:
            return meta, None, None, None
        slot = meta["slot"]
        greedy = None if self._greedy is None else self._greedy[slot]
        return meta, greedy, self._tokens[slot], self._lps[slot]

    def pop(self):
        """Oldest entry -> (meta, greedy, samples, lps)."""
        return self._read(self._meta.popleft())

    def entries(self):
        """Every in-flight entry, oldest first, without consuming (the
        seam capture's read)."""
        for meta in list(self._meta):
            yield self._read(meta)

    def drain_meta(self) -> list[dict]:
        """Drop the buffers (the actor died under them) and return the
        orphaned metadata, so the caller can recount each entry from its
        seed. Handoffs still in flight are received and discarded."""
        metas = list(self._meta)
        for meta in metas:
            landing = meta.pop("landing", None)
            if landing is not None:
                landing()
        self._meta.clear()
        self._tokens = self._lps = self._greedy = None
        self._slot = 0
        return metas


class AsyncSCSTTrainer(SCSTTrainer):
    """SCSTTrainer with the actor/learner ring schedule, on one device or
    split across ranks (module docstring).

    The parent's reward, advantage and update halves are reused as they
    are, on the learner's rows (``self.mesh`` is the learner submesh, or
    None for one learner); the actor gets its own decode
    (:func:`make_actor_decode`) and a :class:`RolloutRing`. ``mesh`` (a
    ``DataMesh``; None: one device) names the layout; ``batch_size``
    clamps a split to batch divisors. ``on_event(event, **fields)``
    receives the preemption, regrow, fallback and seam events.
    """

    # staleness-in-updates buckets: small integers, not latencies
    _STALE_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

    def __init__(self, model, reward, cfg: RLConfig,
                 max_len: int | None = None, guard: bool = False,
                 stats: bool = False, strict: bool = False,
                 batch_size: int = 0, mesh=None, comm=None, on_event=None,
                 retry=None):
        depth = max(1, int(cfg.rollout_depth))
        bound = max(0, int(cfg.staleness_bound))
        # depth 1 + bound 0 IS the strict sequential schedule
        implicit = depth == 1 and bound == 0
        self._strict = bool(strict) or implicit
        if strict:
            # the sync loop's default pipeline is a depth-2 ring (decode(i)
            # one update stale, update(i-1) after decode(i));
            # pipelined=False is the depth-1 sequential ring
            depth = 2 if cfg.pipelined else 1
            bound = depth - 1
        elif implicit:
            depth, bound = 1, 0
        # a ('data', 'mp') grid: the split runs in each column, a row's
        # ranks are replicas
        row = mp_row(mesh)
        grid = mesh if row is not None else None
        if grid is not None:
            mesh = grid.data
        self._full_mesh = mesh
        self._column = set(mesh.global_ranks) if mesh is not None else set()
        self._batch_size = int(batch_size)
        # ranks of a process group: the roles run on different processes
        self._real = (mesh is not None and mesh.group is not None
                      and mesh.world > 1)
        self._me = multihost.process_index() if self._real else 0
        self._grid_plan = None
        if mesh is None:
            plan = None
        elif self._strict:
            plan = shared_plan(mesh)
        else:
            plan = plan_submesh(grid or mesh, cfg.actor_fraction,
                                batch_size=batch_size)
            if grid is not None:
                self._grid_plan, plan = plan, plan.column
        self._plan = plan
        # the pristine plan: a regrow restores membership and order from
        # it, minus the ranks the dead-actor ledger still names as lost
        self._initial_plan = plan
        self._dead_actors: set = set()
        self._generation = 0
        self._bcast_group = None
        super().__init__(model, reward, cfg, max_len=max_len, guard=guard,
                         stats=stats, retry=retry, on_event=on_event,
                         mesh=self._learner_mesh(), comm=comm, row=row)
        self._wg = cfg.baseline == "greedy"
        self._depth = depth
        self._bound = bound
        self._ring = RolloutRing(depth)
        self._fallback_sync = False
        self._actor_model = None
        self._actor_version = -1
        self._learner_version = 0
        self._sends: list = []
        gp = self._grid_plan
        if gp is not None and self._split():
            # every column's broadcast group, in column order on every rank
            # (group creation is collective over the world)
            M = row.world
            for s in range(M):
                multihost.group_of(
                    {gp.learner_ranks[s], *gp.actor_ranks[s::M]})
        self._adopt(plan)
        # per-epoch ledgers the smoke run and the tests read back (the same
        # on every rank)
        self.last_staleness: dict[int, int] = {}
        self.last_dropped = 0
        self.last_rejoined = 0
        self.last_occupancy: dict[str, float] = {}
        self.last_stopped = False
        # host-observed busy windows of the running epoch, by role
        self._windows: dict[str, list] = {"actor": [], "learner": []}

    @property
    def plan(self):
        """The current ``parallel.submesh.SubmeshPlan`` (None without a
        mesh)."""
        return self._plan

    # ---- roles and rows ------------------------------------------------

    def _split(self) -> bool:
        """Whether the roles run on different ranks of a process group."""
        return self._real and not self._plan.shared

    def _is_actor(self) -> bool:
        if not self._split():
            return True
        return not self._fallback_sync and self._me in self._plan.actor_ranks

    def _is_learner(self) -> bool:
        return not self._split() or self._me in self._plan.learner_ranks

    def _rows(self, role: str, B: int) -> slice | None:
        """This rank's rows of a global batch of ``B`` on one side
        (``role`` "actor" or "learner"): all of them in one process, None
        off the side."""
        if not self._real:
            return slice(None)
        side = (self._plan.actor_ranks if role == "actor"
                else self._plan.learner_ranks)
        if self._me not in side:
            return None
        b = B // len(side)
        i = side.index(self._me)
        return slice(i * b, (i + 1) * b)

    def _of_column(self, every: list) -> list:
        """A world-wide gather's per-rank values -> this column's (every
        rank's on a 1-D mesh; a grid's other columns hold replicas)."""
        return [x for r, x in enumerate(every) if r in self._column]

    def _learner_mesh(self):
        """The update's mesh: the learner submesh across ranks, None for a
        single learner (one rank needs no reduction, and its update is the
        one-device update bit for bit) or in one process."""
        if not self._real:
            return None
        lm = self._plan.mesh if self._plan.shared else self._plan.learner
        return lm if lm is not None and lm.world > 1 else None

    def _adopt(self, plan) -> None:
        """Take ``plan`` as the current one: its broadcast group (created
        on every rank, collective over the world) and the actor decode on
        its actor submesh."""
        self._plan = plan
        mesh = None
        if self._real:
            mesh = plan.mesh if plan.shared else plan.actor
        if self._split():
            self._bcast_group = multihost.group_of(self._bcast_ranks())
        cfg = self.cfg
        self._actor_decode = make_actor_decode(
            self.model, cfg.num_rollouts, cfg.temperature, self.max_len,
            with_greedy=self._wg, mesh=mesh)
        self._recount_decode = (
            make_actor_decode(self.model, cfg.num_rollouts, cfg.temperature,
                              self.max_len, with_greedy=self._wg,
                              mesh=plan.learner)
            if self._split() else self._actor_decode)

    def _bcast_ranks(self) -> tuple[int, ...]:
        """The learner root and the live actors: the broadcast's group."""
        root = self._plan.learner_ranks[0]
        return tuple(sorted({root, *self._plan.actor_ranks}))

    # ---- actor plumbing ------------------------------------------------------

    def _refresh_actor(self, state: TrainState) -> None:
        """Point the actor at the learner's current parameters. On one
        device it is a rebind: the model is updated in place on the one
        stream, so a decode launched now sees exactly this version. Across
        ranks the learner root broadcasts its parameters to the live
        actors, which decode with them from now on."""
        if self._actor_version == self._learner_version:
            return
        if not self._split() or self._me in self._bcast_ranks():
            with obs.span("rl.actor.broadcast"):
                if self._split():
                    multihost.broadcast_tensors(
                        [p.data for p in state.model.parameters()],
                        src=self._plan.learner_ranks[0],
                        group=self._bcast_group)
        self._actor_model = state.model
        self._actor_version = self._learner_version

    def _dispatch_decode(self, feats, masks, seed: int, noise_fn,
                         decode=None, model=None):
        """One decode -> (greedy, samples, lps, host copies of (greedy,
        samples) started). The decode's early exit reads the device, so
        its call is the actor's busy window up to the last stride; a
        consume that waits for the tokens adds the rest."""
        t0 = time.perf_counter()
        with obs.span("rl.actor.decode"):
            greedy, samples, lps = (decode or self._actor_decode)(
                self._actor_model if model is None else model, feats, masks,
                seed, noise_fn)
            host = (_host_copy(greedy), _host_copy(samples))
        self._windows["actor"].append((t0, time.perf_counter()))
        obs.counter("rl.actor.batches").inc()
        return greedy, samples, lps, host

    # ---- the handoff across ranks ------------------------------------------

    def _routes(self, B: int) -> list[tuple]:
        """(actor rank, learner rank, first row, end row, the actor's first
        row, the learner's first row) for every pair whose global row
        blocks of a batch of ``B`` overlap."""
        A, L = self._plan.actor_ranks, self._plan.learner_ranks
        ba, bl = B // len(A), B // len(L)
        out = []
        for i, a in enumerate(A):
            for k, lr in enumerate(L):
                lo, hi = max(i * ba, k * bl), min((i + 1) * ba, (k + 1) * bl)
                if lo < hi:
                    out.append((a, lr, lo, hi, i * ba, k * bl))
        return out

    def _specs(self, n: int) -> list:
        K, T = self.cfg.num_rollouts, self.max_len
        specs = [((K, n, T), torch.int32), ((K, n, T), torch.float32)]
        if self._wg:
            specs.append(((n, T), torch.int32))
        return specs

    def _settle_sends(self) -> None:
        for tr in self._sends:
            tr.wait()
        self._sends = []

    def _send_rows(self, greedy, samples, lps, B: int, tag) -> None:
        """An actor's decoded rows -> the learners that own them."""
        self._settle_sends()
        for a, lr, lo, hi, a0, _ in self._routes(B):
            if a != self._me:
                continue
            r = slice(lo - a0, hi - a0)
            parts = [samples[:, r], lps[:, r]]
            if greedy is not None:
                parts.append(greedy[r])
            self._sends.append(multihost.post_send(parts, lr, tag))

    def _recv_rows(self, B: int, n: int, tag):
        """Post the receives of a learner's ``n`` rows of a batch -> the
        landing that waits for them and assembles (greedy, samples,
        lps) on the device."""
        dev = self.model.device
        posted = [(slice(lo - l0, hi - l0), multihost.post_recv(
                      self._specs(hi - lo), a, tag, dev))
                  for a, lr, lo, hi, _, l0 in self._routes(B)
                  if lr == self._me]

        def land():
            K, T = self.cfg.num_rollouts, self.max_len
            samples = torch.empty((K, n, T), dtype=torch.int32, device=dev)
            lps = torch.empty((K, n, T), dtype=torch.float32, device=dev)
            greedy = (torch.empty((n, T), dtype=torch.int32, device=dev)
                      if self._wg else None)
            for r, tr in posted:
                parts = tr.wait()
                samples[:, r] = parts[0]
                lps[:, r] = parts[1]
                if greedy is not None:
                    greedy[r] = parts[2]
            return greedy, samples, lps

        return land

    def _share_metrics(self, m: dict | None) -> dict:
        """A step's metrics on every rank: across split ranks the learner
        root's, with the reward, baseline and advantage means and the
        valid rows combined over every learner's rows."""
        if not self._split():
            return m
        parts = [x for x in self._of_column(multihost.allgather_pyobj(
            m if self._is_learner() else None)) if x is not None]
        out = dict(parts[0])
        rows = [float(x["valid_rows"]) for x in parts]
        total = sum(rows)
        for k in _ROW_MEANS:
            out[k] = (sum(float(x[k]) * v for x, v in zip(parts, rows))
                      / total if total > 0 else 0.0)
        out["valid_rows"] = total
        return out

    # ---- preemption ----------------------------------------------------------

    def _boundary(self, should_stop) -> bool:
        """A batch boundary -> whether the epoch stops here. Visits
        ``rl.actor.step`` (while not fallen back to sync); across ranks
        the stop and the pending requests are agreed in one exchange over
        the world (module docstring)."""
        stop = bool(should_stop()) if should_stop is not None else False
        if not self._real:
            if not stop and not self._fallback_sync:
                chaos.visit("rl.actor.step")
            return stop
        if not self._fallback_sync:
            chaos.visit("rl.actor.step")
        every = multihost.allgather_pyobj(
            [stop, list(_PREEMPT_REQUESTS), list(_REJOIN_REQUESTS)])
        held = [r for r in every if r[1] or r[2]]
        _PREEMPT_REQUESTS[:] = held[0][1] if held else []
        _REJOIN_REQUESTS[:] = held[0][2] if held else []
        return any(r[0] for r in every)

    def _service_preemptions(self) -> list[dict]:
        """Apply pending ``actor_preempt`` requests: shrink the actor set
        (or fall back to sync when nothing survives) and return the
        orphaned ring metadata to recount."""
        lost: list[dict] = []
        while _PREEMPT_REQUESTS:
            idx = _PREEMPT_REQUESTS.pop(0)
            obs.counter("rl.actor.preempted").inc()
            if self._fallback_sync:
                continue
            lost.extend(self._ring.drain_meta())
            new_plan = None
            if self._plan is not None and not self._plan.shared:
                ranks = self._plan.actor_ranks
                self._dead_actors.add(ranks[idx % len(ranks)])
                new_plan = shrink_actors(self._grid_plan or self._plan, idx,
                                         batch_size=self._batch_size)
            if new_plan is None:
                self._fallback_sync = True
                self.on_event("rl_actor_fallback_sync", recount=len(lost))
            else:
                self._generation += 1
                self._adopt(new_plan)
                self.on_event("rl_actor_degraded",
                              survivors=new_plan.n_actors, recount=len(lost))
            self._actor_version = -1    # survivors need a fresh broadcast
        return lost

    def _service_rejoins(self) -> list[dict]:
        """Apply pending ``host_rejoin`` requests: grow the actor set back
        toward the initial plan (climbing out of the sync fallback if the
        shrinks left it there) and return the orphaned ring metadata, so
        the degraded period's in-flight rollouts are recounted in order."""
        lost: list[dict] = []
        while _REJOIN_REQUESTS:
            idx = _REJOIN_REQUESTS.pop(0)
            obs.counter("rl.actor.rejoined").inc()
            init = self._initial_plan
            if init is None or init.shared:
                continue    # nothing was ever split; nothing to grow
            rank = init.actor_ranks[idx % len(init.actor_ranks)]
            self._dead_actors.discard(rank)
            new_plan = grow_actors(
                None if self._fallback_sync else self._plan, rank,
                self._grid_plan or init, batch_size=self._batch_size,
                dead=self._dead_actors)
            if new_plan is None:
                continue    # already present: a duplicate rejoin
            lost.extend(self._ring.drain_meta())
            self._fallback_sync = False
            self._generation += 1
            self._adopt(new_plan)
            self.last_rejoined += 1
            self.on_event("rl_actor_regrown", actors=new_plan.n_actors,
                          recount=len(lost))
            self._actor_version = -1    # the rejoiner needs the broadcast
        return lost

    # ---- the drain's ring seam ---------------------------------------------

    def _seam_capture_ring(self) -> dict:
        """Host copies of every in-flight ring entry (tokens, logprobs,
        seed, batch), each gathered from the ranks that hold its rows into
        the global batch's: the decoupled drain's payload, on every rank.
        Runs once a drain, ``depth`` entries at most."""
        ring = []
        for meta, greedy, samples, lps in self._ring.entries():
            mine = None
            if samples is not None:
                mine = {"samples": samples.cpu().numpy(),
                        "lps": lps.cpu().numpy(),
                        "start": np.asarray(meta["rows"].start or 0)}
                if greedy is not None:
                    mine["greedy"] = greedy.cpu().numpy()
            every = (self._of_column(multihost.allgather_arrays(mine))
                     if self._real else [mine])
            parts = sorted((p for p in every if p is not None),
                           key=lambda p: int(p["start"]))
            e = {"samples": np.concatenate([p["samples"] for p in parts], 1),
                 "lps": np.concatenate([p["lps"] for p in parts], 1),
                 "video_ids": [str(v) for v in meta["all_ids"]],
                 "valid": np.asarray(meta["all_valid"], np.float32),
                 "seed": int(meta["seed"]),
                 "batch_index": int(meta["batch_index"])}
            if "greedy" in parts[0]:
                e["greedy"] = np.concatenate([p["greedy"] for p in parts])
            ring.append(e)
        return {"ring": ring}

    def _replay_entry(self, entry: dict, feats, masks, video_ids, valid_np,
                      batch_index: int, j: int, seed: int) -> None:
        """Push one persisted seam entry back into the ring as if just
        decoded: its tokens and logprobs (this rank's rows of them) come
        from the seam; a later recount decodes from the entry's seed (a
        seam the JAX package wrote stores a key, so the batch's own
        ``seed`` stands in) and batch ``j``'s noise; its version is the
        actor's current one."""
        meta = dict(seed=int(entry.get("seed", seed)), j=j,
                    version=self._actor_version, batch_index=batch_index,
                    all_ids=list(video_ids), all_valid=valid_np)
        rows = self._rows("learner", len(video_ids))
        if rows is None:
            self._ring.push_pending(None, **meta)
            return
        samples = torch.from_numpy(np.asarray(entry["samples"]))[:, rows]
        lps = torch.from_numpy(np.asarray(entry["lps"], np.float32))[:, rows]
        greedy = entry.get("greedy")
        if greedy is not None:
            greedy = torch.from_numpy(np.asarray(greedy))[rows]
        self._ring.push(
            greedy, samples, lps, device=self.model.device, feats=_take(
                feats, rows), masks=_take(masks, rows),
            video_ids=_take(video_ids, rows), valid_np=valid_np[rows],
            rows=rows, host=((greedy, None) if greedy is not None else None,
                             (samples, None)), **meta)

    # ---- the decoupled epoch --------------------------------------------------

    def train_epoch(self, state: TrainState, batches, seeds, on_step=None,
                    pipelined: bool = True, should_stop=None,
                    seam: dict | None = None,
                    seam_sink: dict | None = None, noise_fns=None):
        """Actor/learner epoch -> (state, metrics list). The sync loop's
        ``pipelined`` flag is subsumed by the ring schedule and ignored.
        ``seeds(j)`` and ``noise_fns(j)`` as in
        :meth:`SCSTTrainer.train_epoch` (across ranks, a batch and its
        noise are the global batch's, the same on every rank). Every batch
        not persisted into ``seam_sink`` gets exactly one applied update,
        so the state is ``len(metrics)`` steps on; with ``seam_sink`` a
        stop persists the in-flight ring there, and a resume that passes
        it back as ``seam`` replays its tokens for the batches whose video
        ids match. ``last_stopped`` says whether the epoch stopped at a
        boundary (across ranks: whether any rank asked)."""
        del pipelined
        noise = (lambda j: None) if noise_fns is None else noise_fns
        out: list[dict] = []

        def emit(m):
            out.append(m)
            if on_step is not None:
                on_step(m)

        _PREEMPT_REQUESTS.clear()
        _REJOIN_REQUESTS.clear()
        self._ring = RolloutRing(self._depth)
        self._actor_model = None
        self._actor_version = -1
        self._learner_version = 0
        self.last_staleness = {}
        self.last_dropped = 0
        self.last_rejoined = 0
        self.last_stopped = False
        replay: deque = deque(seam.get("ring", []) if seam else [])
        t0 = time.perf_counter()
        self._windows = {"actor": [], "learner": []}

        def recount(meta, state):
            """Decode an orphaned or over-stale entry again under the
            current parameters, from its own seed and noise (across
            ranks, on the learners: each its own rows)."""
            if not self._split():
                self._refresh_actor(state)
                greedy, samples, lps, host = self._dispatch_decode(
                    meta["feats"], meta["masks"], meta["seed"],
                    _sliced(noise(meta["j"]), meta["rows"]))
                return (dict(meta, version=self._actor_version, host=host),
                        greedy, samples, lps)
            meta = dict(meta, version=self._learner_version)
            if not self._is_learner():
                return meta, None, None, None
            greedy, samples, lps, host = self._dispatch_decode(
                meta["feats"], meta["masks"], meta["seed"],
                _sliced(noise(meta["j"]), meta["rows"]),
                decode=self._recount_decode, model=state.model)
            return dict(meta, host=host), greedy, samples, lps

        def consume(state, meta, greedy, samples, lps):
            """Score and update one ring entry, dropping and recounting it
            first if its parameters are over-stale."""
            learner = self._is_learner()
            m = None
            with (obs.span("rl.learner.step") if learner
                  else contextlib.nullcontext()):
                stale = self._learner_version - meta["version"]
                if stale > self._bound:
                    if learner:
                        obs.counter("rl.staleness.dropped").inc()
                    self.last_dropped += 1
                    meta, greedy, samples, lps = recount(meta, state)
                    stale = self._learner_version - meta["version"]
                self.last_staleness[stale] = (
                    self.last_staleness.get(stale, 0) + 1)
                if learner:
                    obs.histogram("rl.staleness",
                                  self._STALE_BUCKETS).observe(float(stale))
                    # a wait for the tokens' host copies is the actor's;
                    # the score then reads them without a further wait
                    t_wait = time.perf_counter()
                    for copy in meta.get("host") or ():
                        if copy is not None and copy[1] is not None:
                            copy[1].synchronize()
                    self._windows["actor"].append(
                        (t_wait, time.perf_counter()))
                    scored = self._score(greedy, samples, meta["feats"],
                                         meta["masks"], meta["video_ids"],
                                         meta["valid_np"],
                                         host=meta.get("host"))
                    t_disp = time.perf_counter()
                    # the update reads its loss back: it ends on the host
                    state, m = self._apply(state, *scored)
                    self._windows["learner"].append(
                        (t_disp, time.perf_counter()))
                    obs.counter("rl.learner.steps").inc()
            self._learner_version += 1
            emit(self._share_metrics(m))
            return state

        def push(j, feats, masks, video_ids, valid_np, batch_index):
            """Decode batch ``j`` (this rank's rows of it) into the ring;
            across ranks the actors hand their rows to the learners."""
            B = len(video_ids)
            meta = dict(seed=seeds(j), j=j, version=self._actor_version,
                        batch_index=batch_index, all_ids=list(video_ids),
                        all_valid=valid_np)
            if not self._split():
                rows = self._rows("actor", B)
                f, mk = _take(feats, rows), _take(masks, rows)
                greedy, samples, lps, host = self._dispatch_decode(
                    f, mk, meta["seed"], _sliced(noise(j), rows))
                self._ring.push(greedy, samples, lps, feats=f, masks=mk,
                                video_ids=_take(video_ids, rows),
                                valid_np=valid_np[rows], rows=rows,
                                host=host, **meta)
                return
            tag = (j, self._generation)
            if self._is_actor():
                rows = self._rows("actor", B)
                greedy, samples, lps, _ = self._dispatch_decode(
                    _take(feats, rows), _take(masks, rows), meta["seed"],
                    _sliced(noise(j), rows))
                self._send_rows(greedy, samples, lps, B, tag)
            rows = self._rows("learner", B)
            if rows is None:
                self._ring.push_pending(None, **meta)
                return
            self._ring.push_pending(
                self._recv_rows(B, rows.stop - rows.start, tag),
                feats=_take(feats, rows), masks=_take(masks, rows),
                video_ids=_take(video_ids, rows), valid_np=valid_np[rows],
                rows=rows, host=None, **meta)

        def sync_step(state, j, feats, masks, video_ids, valid):
            """The fallback: the sync loop's sequential step on the
            learners' rows (the actors idle)."""
            m = None
            if self._is_learner():
                rows = self._rows("learner", len(video_ids))
                state, m = self.train_step(
                    state, _take(feats, rows), _take(masks, rows),
                    _take(video_ids, rows), seeds(j), _take(valid, rows),
                    noise_fn=_sliced(noise(j), rows))
            self._learner_version += 1
            emit(self._share_metrics(m))
            return state

        stopped = False
        batch_index = -1
        try:
            for j, (feats, masks, video_ids, valid) in enumerate(batches):
                batch_index += 1
                if self._boundary(should_stop):
                    stopped = True
                    break
                # rejoins first: a rejoin and a preempt landing on the same
                # boundary grow then shrink, in that order
                lost = self._service_rejoins() + self._service_preemptions()
                for meta in lost:
                    # the orphaned in-flight rollouts, in order
                    state = consume(state, *recount(meta, state))
                if self._fallback_sync:
                    state = sync_step(state, j, feats, masks, video_ids, valid)
                    continue
                self._refresh_actor(state)
                valid_np = self._valid_np(valid, len(video_ids))
                if replay and list(replay[0]["video_ids"]) == [
                        str(v) for v in video_ids]:
                    self._replay_entry(replay.popleft(), feats, masks,
                                       video_ids, valid_np, batch_index, j,
                                       seeds(j))
                else:
                    if replay:
                        # a changed data order: never marry old tokens to new
                        # features
                        self.on_event("seam_ring_discarded",
                                      entries=len(replay))
                        replay.clear()
                    push(j, feats, masks, video_ids, valid_np, batch_index)
                while len(self._ring) >= self._depth:
                    state = consume(state, *self._ring.pop())
            self.last_stopped = stopped
            if stopped and seam_sink is not None and len(self._ring):
                # a drain: the in-flight ring persists instead of being
                # consumed, and the resume replays these tokens
                seam_sink.update(self._seam_capture_ring())
            else:
                while len(self._ring):
                    state = consume(state, *self._ring.pop())
        except Exception:
            # a step that raised alike on every rank (a sentinel rollback):
            # every handoff in flight is posted on both sides, so complete
            # them, or the next epoch's transfers would pair with these
            if self._split():
                self._ring.drain_meta()
                self._settle_sends()
            raise
        self._settle_sends()
        wall = max(time.perf_counter() - t0, 1e-9)
        occ = self._occupancy(wall)
        self.last_occupancy = occ
        obs.gauge("rl.actor.occupancy").set(occ["actor"])
        obs.gauge("rl.learner.occupancy").set(occ["learner"])
        if self._split():
            # every rank leaves with the learner's state
            state = replicate(self._full_mesh, state,
                              src=self._plan.learner_ranks[0])
        return state, out

    def _occupancy(self, wall: float) -> dict:
        """Host-observed busy share of each role over the epoch's wall;
        across ranks the mean over the ranks that held the role, and the
        longest wall, alike on every rank."""
        mine = {role: _covered_s(w) for role, w in self._windows.items()}
        if not self._real:
            return {role: min(1.0, s / wall) for role, s in mine.items()} \
                | {"wall_s": wall}
        every = multihost.allgather_pyobj([mine, wall])
        init = self._initial_plan
        occ = {}
        for role in ("actor", "learner"):
            side = (init.actor_ranks if role == "actor"
                    else init.learner_ranks)
            held = [min(1.0, m[role] / w) for r, (m, w) in enumerate(every)
                    if r in side]
            occ[role] = float(np.mean(held)) if held else 0.0
        occ["wall_s"] = max(w for _, w in every)
        return occ
