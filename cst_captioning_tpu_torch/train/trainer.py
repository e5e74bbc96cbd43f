"""The training loop (the JAX package's ``train/trainer.py``): XE
epochs, greedy validation by CIDEr-D, best/latest checkpoints, resume, the
XE -> RL handoff and CST epochs, on one device or data parallel.

Batches are collated and staged on the device by the prefetch thread
(``data/prefetch.py``). Both phase loops run under a SIGTERM handler: a
preemption saves a mid-epoch checkpoint that records the batch index, and
the epoch-keyed shuffle lets a resumed run train exactly the rest of the
epoch; a drained pipelined RL epoch also saves its seam (``seam.npz``, in
the same atomic save) so the resumed run replays it. A divergence
sentinel applies ``train.on_divergence``; ``train.ckpt_every_steps`` adds
mid-epoch ``step_*`` checkpoints with keep-last-K rotation.

Initial parameters are seeded numpy draws in the JAX layout
(``convert.random_flax_params`` at ``train.seed``), the same on every
device; ``params=`` starts from a given flax tree instead. Epoch events
carry clips/s and the median step ms from a host timer.

Observability (``train.obs``, the JAX trainer's wiring): the obs recorder
at ``train.obs_dir`` or ``<ckpt_dir>/obs`` with the ``device.peak_flops``
gauge (the datasheet peak of the card, ``obs/flops.py``); the ``setup``,
``xe.epoch``, ``xe.step``, ``rl.epoch`` and ``ckpt`` spans, the run
context and cadenced snapshots; ``StepMeter`` and ``StepProfiler``
(``train.profile_dir``) in both loops; the analytic ``flops.xe.step``
counter; and with ``train.recorder_steps > 0`` the flight recorder (the
steps' update ratios, one readback each ``log_every_steps`` and at epoch
ends) with ``train.anomaly``'s detector, dumping postmortems on sentinel
trips and SIGTERM saves. With obs off the loops run no extra device work.

``train.rl_topology="decoupled"`` runs the RL epochs through
``rl.async_scst.AsyncSCSTTrainer``: the actor/learner ring on one device,
or, on a mesh of several ranks, the ranks split into actor and learner
ranks (``parallel.submesh.plan_submesh`` at ``rl.actor_fraction``), every
rank fed the global batch from the same seeded batcher and sliced by
role. Every rank sees the same steps and leaves each epoch holding the
learner's state, so rank 0 (an actor) writes the learner's parameters and
moments; a drain gathers the learners' in-flight ring into the one
``seam.npz``, and a stop any rank asks for drains every rank.

Resilience beyond the sentinel: ``train.spike_mode="adaptive"`` takes
the sentinel's spike bound from the loss EWMA (``resilience/adaptive.py``,
sharing the anomaly detector's when it is live); ``train.debug_nans`` turns
on autograd's anomaly mode and makes every module check its output, raising
``FloatingPointError`` at the first one that is not finite (both undone by
:meth:`Trainer.close`). The chaos points (``resilience/chaos.py``):
``xe.batch`` and ``rl.batch`` on the prefetch worker with the ``Batch``,
before it is collated into arrays; ``xe.step`` once per dispatched XE step
and ``rl.step`` once per completed RL step, on the main thread.

Peer loss (``train.health``, the JAX trainer's elastic paths): the
trainer starts a ``resilience.health.HealthMonitor`` (host ``host_id`` of
``train.health_sim_hosts`` simulated hosts, or of the launch's ranks;
heartbeats in ``train.health_dir`` or ``<ckpt_dir>/health``) and stops it
in :meth:`Trainer.close`. Both loops note the step for the heartbeat and
read ``peer_lost`` once a step, beside the SIGTERM checks; a loss drains
the epoch at a batch boundary (the pipelined or decoupled RL epoch in
schedule order, its seam saved), saves a mid-epoch checkpoint, dumps a
``peer_loss`` postmortem naming the lost hosts and raises ``PeerLost``.
``elastic="strict"`` ends the run there: a restart with
``train.resume="auto"`` and a fresh health directory resumes from that
save.

``elastic="degraded"`` goes on instead (:meth:`Trainer._continue_degraded`):
the survivors rendezvous at the next membership generation, the lowest
live host publishes it and marks the lost hosts with tombstones, the
group is re-formed over the survivors (``multihost.regroup``), every
survivor restores the drain save by name, and the mesh, gradient reducer,
XE step, evaluator and batch share (in RL also the SCST trainer and its
batcher, ``_build_scst``) are rebuilt for the new world; the phase loop
replays the rest of the epoch on the same global batch. With
``elastic_regrow`` the survivors poll for rejoin markers at every batch
boundary (the ``health.rejoin`` chaos point); a validated rejoiner is
admitted at a drained boundary: a rendezvous, a regroup over every live
host, the survivors' drain save restored by name on every member and
replicated from rank 0. A rejoin whose rendezvous times out is refused
and the run goes on as it was. One process with ``health_sim_hosts``
simulates the hosts over its one device, as the JAX trainer over its
mesh.

Host ids and ranks: a process keeps its launch rank as its host id for
its whole life (the monitor's host, its ``proc<k>/`` obs stream, its
``<log>.proc<k>.jsonl``, the ``lost`` / ``survivors`` / ``rejoiner``
fields); :attr:`rank` and :attr:`world` are the current generation's (its
index among the live hosts). A host restarted with the run's config finds
its tombstone (``is_rejoining``; ``cli.train`` then forms no launch group),
asks for the next generation and joins the survivors at their next
boundary, taking their drain save: it never trusts a checkpoint of its
own.

On real ranks a drain enters no collective of the group that held the
dead rank: a pending pipelined RL update is not applied and the save
carries no seam (``SCSTTrainer.train_epoch``'s ``abandon``). A collective
that raises (the XE step, the RL update, validation, the epoch's
exchanges) is a peer loss when the monitor confirms one within its
detection window, and drains the same way, the step in flight not
applied; otherwise the error stands. The lowest live host writes every
checkpoint, with no barrier on a group that lost a host. Refused: a loss
during a split (decoupled across ranks) RL epoch, and a global batch the
live world does not divide (a regrow to such a world is refused).

Data parallel (``use_mesh``; None means more than one host, launched one
process a device, ``train/multihost.py``): a 1-D ``train.mesh.DataMesh``;
each rank collates its contiguous rows of every global batch
(``Batcher(host_shard=(rank, world))``; the batch size must divide), the
steps are ``make_parallel_xe_step`` and the data-parallel
``SCSTTrainer``, and ``replicate`` broadcasts rank 0's state after the
init and after every restore. A barrier follows each epoch save so that
no rank runs ahead of a file it may resume from; every rank resumes from
the shared directory. Validation runs on every rank (the sharded
evaluator).

Not ported (ROADMAP.md names their slices): the model- and
sequence-parallel meshes; their config fields raise (``config.py``).
"""

from __future__ import annotations

import io
import itertools
import json
import os
import threading
import time

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.ckpt import CheckpointManager, load_params
from cst_captioning_tpu_torch.config import EvalConfig, ExperimentConfig
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    random_flax_params,
)
from cst_captioning_tpu_torch.data.batcher import Batcher
from cst_captioning_tpu_torch.data.prefetch import prefetch_to_device
from cst_captioning_tpu_torch.device import resolve_device
from cst_captioning_tpu_torch.eval.evaluator import Evaluator
from cst_captioning_tpu_torch.metrics.cider import CorpusDF
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.obs import anomaly as _anomaly
from cst_captioning_tpu_torch.obs import flops as _flops
from cst_captioning_tpu_torch.obs import recorder as flight
from cst_captioning_tpu_torch.parallel.comms import CommConfig
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.resilience import health as health_mod
from cst_captioning_tpu_torch.resilience.adaptive import AdaptiveThresholds
from cst_captioning_tpu_torch.resilience.health import PeerLost
from cst_captioning_tpu_torch.resilience.preempt import (
    Preempted,
    PreemptionHandler,
)
from cst_captioning_tpu_torch.resilience.sentinel import (
    DivergenceSentinel,
    RollbackRequested,
    TrainingDiverged,
)
from cst_captioning_tpu_torch.rl import (
    AsyncSCSTTrainer,
    RewardComputer,
    SCSTTrainer,
)
from cst_captioning_tpu_torch.rl.scst import rollout_seed
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import (
    batch_sharding,
    make_mesh,
    replicate,
)
from cst_captioning_tpu_torch.train.schedule import make_optimizer
from cst_captioning_tpu_torch.train.state import create_train_state
from cst_captioning_tpu_torch.train.steps import (
    make_parallel_xe_step,
    make_xe_step,
    xe_row_weights,
)
from cst_captioning_tpu_torch.utils.logging import EventLogger
from cst_captioning_tpu_torch.utils.profiling import StepProfiler

# run plumbing that may differ between a run and its resume; left out of
# the config-drift check
_VOLATILE_CONFIG_FIELDS = frozenset({
    "train.resume", "train.ckpt_dir", "train.profile_dir",
    "train.profile_steps", "train.debug_nans", "train.log_every_steps",
    "train.ckpt_every_steps", "train.keep_ckpts", "train.max_rollbacks",
    "train.health", "train.health_dir", "train.health_interval_s",
    "train.peer_timeout_s", "train.health_misses", "train.health_sim_hosts",
    "train.dcn_stall_s",
    "train.obs", "train.obs_dir", "train.recorder_steps", "train.anomaly",
    "eval.results_json",
})

__all__ = ["PeerLost", "Preempted", "Trainer", "TrainingDiverged"]


def _config_drift(saved: dict, current: dict, prefix: str = "") -> list[str]:
    """Dotted paths whose values differ between two JSON-born snapshots."""
    out: list[str] = []
    for key in sorted(set(saved) | set(current)):
        path = f"{prefix}{key}"
        if path in _VOLATILE_CONFIG_FIELDS:
            continue
        a, b = saved.get(key), current.get(key)
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(_config_drift(a, b, prefix=path + "."))
        elif a != b:
            out.append(path)
    return out


def _rate(batch: int, times: list[float]) -> tuple[float, float]:
    """(clips/s past the first step, median step ms) of a phase epoch."""
    if not times:
        return 0.0, 0.0
    timed = times[1:] or times
    return (batch * len(timed) / max(sum(timed), 1e-12),
            float(np.median(timed)) * 1e3)


class _NanHooks:
    """``train.debug_nans``: autograd's anomaly mode (a backward that
    makes a NaN raises at the op) and a forward hook on every module of
    ``model`` that raises ``FloatingPointError`` naming the first module
    whose output is not finite. The hooks only read their outputs. Both
    are process-wide state, so :meth:`remove` restores them."""

    def __init__(self, model: torch.nn.Module):
        self._anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
        self._handles = [m.register_forward_hook(self._hook(name or "model"))
                         for name, m in model.named_modules()]

    @staticmethod
    def _hook(name: str):
        def check(module, args, output):
            for t in _tensor_leaves(output):
                if t.is_floating_point() and not bool(
                        torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"debug_nans: the output of module {name!r} "
                        f"({type(module).__name__}) is not finite")
        return check

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        torch.autograd.set_detect_anomaly(self._anomaly)


def _tensor_leaves(x) -> list[torch.Tensor]:
    """The tensors of a module's output (a tensor, or nested tuples of
    them: the encoders' and cells' outputs)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensor_leaves(v)]
    return []


def health_dir(cfg: ExperimentConfig) -> str:
    """The run's health directory (heartbeats, tombstones, rendezvous)."""
    return cfg.train.health_dir or os.path.join(cfg.train.ckpt_dir, "health")


def is_rejoining(cfg: ExperimentConfig, host_id: int) -> bool:
    """Whether host ``host_id`` starting with ``cfg`` is a host the run
    lost coming back: ``elastic="degraded"`` with the monitor on, and its
    tombstone (written by the survivors' continuation) in the health
    directory. Such a host joins the survivors' next generation instead of
    forming the launch's group (``cli.train`` asks this first)."""
    return bool(cfg.train.health and cfg.train.elastic == "degraded"
                and os.path.exists(os.path.join(health_dir(cfg),
                                                f"host{int(host_id)}.dead")))


# the trainer's own control flow, never a collective's error
_CONTROL = (PeerLost, health_mod.HostRejoin, RollbackRequested,
            TrainingDiverged, Preempted)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, train_ds, val_ds=None,
                 log_path: str = "", device=None, params=None,
                 use_mesh: bool | None = None):
        self.cfg = cfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.device = multihost.local_device(resolve_device(device))
        # a process keeps its launch rank as its host id for its whole life
        # (the monitor's host, its obs stream and event log); its group
        # rank and world follow the membership generation
        self.host_id, self._hosts = multihost.host_identity()
        self.rank, self.world = multihost.host_shard()
        n_dev = cfg.mesh.num_devices or self._hosts
        self.use_mesh = n_dev > 1 if use_mesh is None else use_mesh
        # analytic FLOPs per teacher-forced XE row (obs/flops.py): the
        # flops.xe.step counter behind the run report's MFU column
        mc = cfg.model
        self._xe_flops_per_row = _flops.xe_flops_per_row(
            T=mc.max_len, F=mc.max_frames, d_embed=mc.d_embed,
            d_hidden=mc.d_hidden, d_att=mc.d_att, V=mc.vocab_size,
            feat_dims=tuple(d for _, d in mc.modalities),
            num_layers=mc.num_layers)
        self._xe_probed = False
        obs_dir = cfg.train.obs_dir or os.path.join(cfg.train.ckpt_dir, "obs")
        if self.host_id != 0:
            # one stream a process, as the JSONL log
            obs_dir = os.path.join(obs_dir, f"proc{self.host_id}")
        if cfg.train.obs:
            obs.configure(obs_dir, run=cfg.name,
                          snapshot_every=cfg.train.log_every_steps)
            # the report's MFU column divides the flops.<phase> counters by
            # this datasheet peak (0 off the table: no MFU)
            obs.gauge("device.peak_flops").set(_flops.peak_flops(
                torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else self.device.type))
        # the flight recorder: the steps add their update ratios (extra
        # outputs; the parameters are the same bit for bit)
        self._stats = bool(cfg.train.obs and cfg.train.recorder_steps > 0)
        self._detector = (_anomaly.AnomalyDetector()
                          if self._stats and cfg.train.anomaly else None)
        if self._stats:
            flight.configure(cfg.train.recorder_steps, obs_dir, run=cfg.name,
                             detector=self._detector, config=cfg.to_dict(),
                             proc=self.host_id, world=self._hosts)
        # everything below (the model, state, resume) is run setup: its
        # span keeps the report's coverage honest
        setup_span = obs.span("setup").begin()
        self.model = CaptionModel(cfg.model, device=self.device)
        load_flax_params(self.model, params if params is not None
                         else random_flax_params(cfg.model, cfg.train.seed))
        self._nan_hooks = (_NanHooks(self.model) if cfg.train.debug_nans
                           else None)
        if log_path and self.host_id != 0:
            # one event log a process: host k writes <name>.proc<k><ext>
            root, ext = os.path.splitext(log_path)
            log_path = f"{root}.proc{self.host_id}{ext}"
        self.log = EventLogger(log_path)
        # the elastic bookkeeping (the JAX trainer's): the membership
        # generation, the device layout now and at the start (a regrow
        # rebuilds from the original), a validated rejoiner awaiting its
        # boundary, and the last step save, which the continuations
        # restore by name
        self._degraded_gen = 0
        self._regrow_host: int | None = None
        self._last_step_ckpt: str | None = None
        # the hosts are processes of their own: a loss regroups them
        self._real_ranks = self._hosts > 1
        self._members = list(range(self._hosts))   # this generation's hosts
        self.rejoined = False
        self.health: health_mod.HealthMonitor | None = None
        if cfg.train.health:
            health_mod.set_dcn_stall_threshold(cfg.train.dcn_stall_s)
            self.health = health_mod.HealthMonitor(
                health_dir(cfg), host_id=self.host_id,
                num_hosts=cfg.train.health_sim_hosts or self._hosts,
                interval_s=cfg.train.health_interval_s,
                timeout_s=cfg.train.peer_timeout_s,
                misses=cfg.train.health_misses, log=self.log.log)
            self.health.real_hosts = self._real_ranks
        # a host of a multi-process run without the launch's group was
        # restarted into the run (cli.train found its tombstone)
        rejoining = self._real_ranks and not multihost.is_multiprocess() \
            and self.world == 1
        if rejoining and not (self.health is not None
                              and cfg.train.elastic == "degraded"
                              and self.health.has_tombstone()):
            raise ValueError(
                f"host {self.host_id} of {self._hosts} has no process group "
                "and is not a host the run lost (no tombstone of it in "
                f"{health_dir(cfg)} under train.elastic='degraded'); form "
                "the group with multihost.initialize")
        if self.health is not None:
            if rejoining:
                self.health.continue_seq()
            self.health.start()
        if rejoining:
            self._join_next_generation()
        self.mesh = (make_mesh(0 if self._degraded_gen
                               else cfg.mesh.num_devices, device=self.device)
                     if self.use_mesh else None)
        self._check_batch_divides()
        # the device layout: one device a host on real ranks (a device is
        # its host's id), else the one device this process drives
        members = self._members
        self._original_mesh_devices = (
            None if self.mesh is None
            else list(range(self._hosts)) if self._real_ranks
            else list(range(self.mesh.world)))
        self._all_mesh_devices = (
            None if self.mesh is None
            else members if self._real_ranks
            else list(self._original_mesh_devices))
        self._original_hosts = (cfg.train.health_sim_hosts or self._hosts
                                if cfg.train.health else 1)
        self._initial_hosts = (len(members) if rejoining
                               else self._original_hosts)
        # each rank collates its rows of every global batch (the shuffle
        # is epoch-keyed, so the ranks agree without communicating)
        self.batcher = Batcher(
            train_ds, batch_size=cfg.data.batch_size,
            max_len=cfg.model.max_len, mode="caption",
            seq_per_vid=cfg.data.seq_per_vid, seed=cfg.data.shuffle_seed,
            host_shard=self._host_shard())
        self.steps_per_epoch = self.batcher.num_batches()
        tx = make_optimizer(cfg.train, self.steps_per_epoch)
        self.state = create_train_state(self.model, tx, seed=cfg.train.seed)
        if not rejoining:
            # a rejoiner takes the survivors' state below
            self.state = self._replicate(self.state)
        # the finite-update guard rides with any active sentinel policy
        self.guard = cfg.train.on_divergence != "off"
        self.comm = CommConfig.from_train(cfg.train)
        self._build_xe_step()
        if multihost.is_multiprocess():
            # evidence the group formed (a failed one would train N copies)
            self.log.log("distributed", processes=self.world,
                         process_index=self.rank, devices=self.world,
                         backend=multihost.backend())
        self.ckpt = CheckpointManager(
            cfg.train.ckpt_dir, metric="CIDEr-D", keep=cfg.train.keep_ckpts,
            log=self.log.log)
        self.epoch = 0        # global epoch counter (batch-order key)
        self.xe_epochs = 0    # per-phase progress; the epochs fields are
        self.rl_epochs = 0    # phase totals, so a resume trains the rest
        self._resume_batch = 0
        self._resume_rl_batch = 0
        self._rollbacks = 0
        self._rl_batcher: Batcher | None = None
        self.reward: RewardComputer | None = None
        # tokens a drained pipelined RL epoch decoded but did not score
        self._pending_seam: dict | None = None
        if rejoining:
            self._adopt_rejoin()
        elif cfg.train.resume:
            self._resume()
        self._build_validator()
        setup_span.end()

    def _check_batch_divides(self) -> None:
        if self.mesh is not None and self.cfg.data.batch_size \
                % self.mesh.world:
            # unlike eval (which wrap-pads), padding a training batch would
            # change how rows group into optimizer steps
            raise ValueError(
                f"training batch_size {self.cfg.data.batch_size} must be "
                f"divisible by the mesh's {self.mesh.world}-device 'data' "
                "axis; pick a multiple or set mesh.num_devices/seq_devices")

    def _host_shard(self) -> tuple[int, int]:
        return batch_sharding(self.mesh) if self.mesh is not None else (0, 1)

    def _replicate(self, state):
        """Rank 0's state on every rank (a no-op without a mesh)."""
        return replicate(self.mesh, state) if self.mesh is not None \
            else state

    def _build_xe_step(self) -> None:
        """(Re)build the XE step for the current mesh: at init and after
        every shrink or regrow (its gradient reducer holds the group)."""
        if self.mesh is not None:
            self.xe_step = make_parallel_xe_step(
                self.model, self.mesh, self.cfg.train.label_smoothing,
                guard=self.guard, comm=self.comm, stats=self._stats)
        else:
            self.xe_step = make_xe_step(
                self.model, self.cfg.train.label_smoothing, guard=self.guard,
                stats=self._stats)

    def _build_validator(self) -> None:
        cfg = self.cfg
        self.validator = (
            Evaluator(self.model, self.val_ds,
                      EvalConfig(beam_size=1, max_len=cfg.model.max_len,
                                 metrics=("CIDEr-D",)),
                      batch_size=cfg.data.batch_size, mesh=self.mesh)
            if self.val_ds is not None else None)

    def close(self) -> None:
        """Stop the health watchdog, close the event log and the flight
        recorder (a final flush, no postmortem; a run that dies before this
        still dumps through the recorder's atexit hook), and undo
        ``debug_nans``. The obs recorder is the CLI's to shut."""
        if self.health is not None:
            self.health.stop()
        if self._stats:
            flight.shutdown()
        if self._nan_hooks is not None:
            self._nan_hooks.remove()
            self._nan_hooks = None
        self.log.close()

    def _xe_flops_inc(self, rows: int) -> float:
        """FLOPs to count for one XE step: the analytic per-row model (the
        JAX trainer prefers a compiled program's cost here; a PyTorch step
        has none, and the backend gauge says "analytic")."""
        if not self._xe_probed and obs.enabled():
            self._xe_probed = True
            obs.counter("obs.flops.probes").inc()
            obs.gauge("flops.backend.xe.step").set(0.0)
        return rows * self._xe_flops_per_row

    # ---- resume / handoff ----------------------------------------------------

    def _resume(self):
        # "auto": the newest valid checkpoint of this run's ckpt_dir;
        # a directory: the newest valid one in it
        resume = self.cfg.train.resume
        src_dir = self.cfg.train.ckpt_dir if resume == "auto" else resume
        mgr = (self.ckpt if resume == "auto"
               else CheckpointManager(src_dir, log=self.log.log))
        restored = mgr.restore_latest(self.state)
        if restored is None:
            self.log.log("resume_not_found", dir=src_dir)
            return
        state, infos = restored
        batch_index, phase = self._adopt_restored(state, infos, src_dir)
        saved_cfg = infos.get("config")
        if saved_cfg:
            drift = _config_drift(saved_cfg, json.loads(self.cfg.to_json()))
            if drift:
                self.log.log("resume_config_drift", fields=drift)
        self.log.log("resume", dir=src_dir, step=int(state.step),
                     epoch=self.epoch, batch_index=batch_index,
                     phase=phase or "epoch_end",
                     restore_ms=mgr.last_restore.get("ms"))

    def _adopt_restored(self, state, infos: dict,
                        src_dir: str) -> tuple[int, str]:
        """Install a restored state's bookkeeping -> (batch_index, phase)."""
        self.state = self._replicate(state)
        self.epoch = int(infos.get("epoch", 0))
        self.xe_epochs = int(infos.get("xe_epochs", self.epoch))
        self.rl_epochs = int(infos.get("rl_epochs", 0))
        # the caption batcher takes one epoch index per XE epoch (RL epochs
        # run their own video-mode batcher), so the XE count is its key
        self.batcher.epoch_index = self.xe_epochs
        # a mid-epoch save: the counters are completed epochs, batch_index
        # how far into the next one the save came
        batch_index = int(infos.get("batch_index", 0))
        phase = infos.get("phase", "")
        self._resume_batch = self._resume_rl_batch = 0
        if batch_index and phase == "xe":
            self._resume_batch = batch_index
        elif batch_index and phase == "rl":
            self._resume_rl_batch = batch_index
        self.batcher.salt = int(infos.get("data_salt", 0))
        self._pending_seam = self._load_seam(src_dir, infos)
        return batch_index, phase

    # ---- the RL seam -----------------------------------------------------------

    @staticmethod
    def _seam_bytes(seam: dict, epoch: int, batch_index: int) -> bytes:
        """A captured seam and its position as ``seam.npz`` bytes: the
        pipelined loop's tokens, or the decoupled loop's in-flight ring
        flattened as ``ring{i}_*`` (the JAX package's layout; the port
        writes ``ring{i}_seed`` where the JAX package writes the key data
        ``ring{i}_rng``)."""
        arrays = {"epoch": np.asarray(int(epoch)),
                  "batch_index": np.asarray(int(batch_index))}
        if "ring" in seam:
            arrays["ring_n"] = np.asarray(len(seam["ring"]))
            for i, e in enumerate(seam["ring"]):
                arrays[f"ring{i}_samples"] = np.asarray(e["samples"])
                arrays[f"ring{i}_lps"] = np.asarray(e["lps"])
                arrays[f"ring{i}_video_ids"] = np.asarray(
                    [str(v) for v in e["video_ids"]])
                arrays[f"ring{i}_valid"] = np.asarray(e["valid"])
                arrays[f"ring{i}_seed"] = np.asarray(int(e["seed"]))
                arrays[f"ring{i}_batch_index"] = np.asarray(
                    int(e["batch_index"]))
                if e.get("greedy") is not None:
                    arrays[f"ring{i}_greedy"] = np.asarray(e["greedy"])
        else:
            arrays["samples"] = np.asarray(seam["samples"])
            arrays["video_ids"] = np.asarray([str(v) for v in
                                              seam["video_ids"]])
            if seam.get("greedy") is not None:
                arrays["greedy"] = np.asarray(seam["greedy"])
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @staticmethod
    def _ring_entry(z, i: int) -> dict:
        """Ring entry ``i`` of a loaded ``seam.npz``. An entry the JAX
        package wrote carries its key data (``ring{i}_rng``), which is not
        a port seed: it has no ``seed``, so the resumed epoch replays its
        tokens and a later recount decodes from the port's
        ``rollout_seed`` of that batch."""
        p = f"ring{i}_"
        e = {"samples": np.asarray(z[p + "samples"]),
             "lps": np.asarray(z[p + "lps"]),
             "video_ids": [str(v) for v in z[p + "video_ids"]],
             "valid": np.asarray(z[p + "valid"]),
             "batch_index": int(z[p + "batch_index"])}
        if p + "seed" in z.files:
            e["seed"] = int(z[p + "seed"])
        if p + "greedy" in z.files:
            e["greedy"] = np.asarray(z[p + "greedy"])
        return e

    def _load_seam(self, src_dir: str, infos: dict) -> dict | None:
        """The seam of the checkpoint just restored, when its save drained
        a pipelined or decoupled RL epoch."""
        name = infos.get("ckpt_name", "")
        if not name or infos.get("phase") != "rl" \
                or not infos.get("batch_index"):
            return None
        path = os.path.join(src_dir, name, "seam.npz")
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                seam = {"epoch": int(z["epoch"]),
                        "batch_index": int(z["batch_index"])}
                if "ring_n" in z.files:
                    seam["ring"] = [Trainer._ring_entry(z, i)
                                    for i in range(int(z["ring_n"]))]
                else:
                    seam.update(
                        samples=np.asarray(z["samples"]),
                        greedy=(np.asarray(z["greedy"])
                                if "greedy" in z.files else None),
                        video_ids=[str(v) for v in z["video_ids"]])
        except (OSError, ValueError, KeyError) as e:
            # a torn seam falls back to decoding the batch again
            self.log.log("seam_unreadable", path=path,
                         error=type(e).__name__, detail=str(e))
            return None
        self.log.log("seam_loaded", ckpt=name, epoch=seam["epoch"],
                     batch_index=seam["batch_index"])
        return seam

    def load_params_from(self, ckpt_dir: str, name: str = "best"):
        """XE -> RL handoff: params only (the optimizer starts fresh)."""
        load_params(ckpt_dir, name, self.model)
        self.state = self._replicate(self.state)
        self.log.log("handoff", source=f"{ckpt_dir}/{name}")

    # ---- batches ---------------------------------------------------------------

    def _device_batches(self, batcher: Batcher, skip: int = 0,
                        stop_event: threading.Event | None = None):
        """XE batches on the device: (feats, masks, labels, mask, weights,
        valid); ``skip`` drops the first batches of the epoch's order."""
        def transform(b):
            b = chaos.visit("xe.batch", b)
            return (b.feats, b.feat_masks, b.labels.astype(np.int64), b.mask,
                    b.weights, np.asarray(b.valid, np.float32))

        it = itertools.islice(batcher.epoch(), skip, None)
        yield from prefetch_to_device(
            it, size=self.cfg.data.prefetch, transform=transform,
            stop_event=stop_event, device=self.device)

    def _rl_device_batches(self, batcher: Batcher, skip: int = 0,
                           stop_event: threading.Event | None = None):
        """RL batches: features on the device, video ids and the valid
        flags (lists) on the host for the reward."""
        def transform(b):
            b = chaos.visit("rl.batch", b)
            return (b.feats, b.feat_masks, list(b.video_ids),
                    [bool(v) for v in b.valid])

        it = itertools.islice(batcher.epoch(shuffle=True), skip, None)
        yield from prefetch_to_device(
            it, size=self.cfg.data.prefetch, transform=transform,
            stop_event=stop_event, device=self.device)

    # ---- resilience ------------------------------------------------------------

    def _make_sentinel(self, phase: str) -> DivergenceSentinel:
        """skip_batch checks at epoch ends and save points; rollback and
        abort every 32 steps. ``spike_mode="adaptive"`` adds the EWMA
        bound: the anomaly detector's loss stream when it is live (updated
        at the recorder's flushes), else a private one fed by the
        sentinel's checks."""
        cfg = self.cfg.train
        adaptive = None
        if cfg.spike_mode == "adaptive" and cfg.spike_factor:
            adaptive = AdaptiveThresholds(
                factor_max=cfg.spike_factor, factor_min=cfg.spike_factor_min,
                ewma=(self._detector.ewma("loss")
                      if self._detector is not None else None))
        return DivergenceSentinel(
            policy=cfg.on_divergence, phase=phase, log=self.log.log,
            spike_factor=cfg.spike_factor,
            check_every=(32 if cfg.on_divergence in ("rollback", "abort")
                         else None),
            adaptive=adaptive)

    def _ckpt_infos(self, phase: str = "", batch_index: int = 0,
                    step_no: int | None = None) -> dict:
        return {
            "epoch": self.epoch,
            "xe_epochs": self.xe_epochs,
            "rl_epochs": self.rl_epochs,
            "phase": phase,
            "batch_index": batch_index,
            "global_step": step_no,
            "data_salt": self.batcher.salt,
            "config": self.cfg.to_dict(),
        }

    def _is_writer(self) -> bool:
        """Whether this host writes the checkpoints: the lowest live one.
        That is rank 0 of the generation, and, while a drain runs on a
        group that lost hosts, the lowest survivor the monitor knows (the
        lost one may have been rank 0)."""
        if self.health is not None and self._real_ranks:
            return self.host_id == min(self.health.survivors())
        return self.rank == 0

    def _save_step_ckpt(self, phase: str, step_no: int, batch_index: int,
                        seam: dict | None = None,
                        barrier: bool = True) -> None:
        """A mid-epoch checkpoint recording the batch index; ``seam``
        rides along as ``seam.npz`` in the same swap. The lowest live host
        writes; with ``barrier`` every rank then waits for the file (the
        peer-loss and regrow drains skip it: a lost peer would never
        arrive, and the continuation's rendezvous, which the writer enters
        only once its save is durable, orders the rest)."""
        writer = self._is_writer()
        if writer:
            extra = None
            if seam:
                extra = {"seam.npz": self._seam_bytes(seam, self.epoch,
                                                      batch_index)}
            with obs.span("ckpt", kind="step"):
                self.ckpt.save_step(
                    self.state, step_no,
                    self._ckpt_infos(phase, batch_index, step_no),
                    extra_files=extra)
        # the elastic continuations restore this save by name (an older
        # epoch-end save may rank above a drain's in another phase)
        self._last_step_ckpt = f"step_{int(step_no):08d}"
        if barrier:
            multihost.barrier("ckpt.save")
        self.log.log("ckpt_step", phase=phase, step=step_no,
                     batch_index=batch_index, seam=bool(seam),
                     **(self.ckpt.last_save if writer else {}))

    def _preempt_save(self, phase: str, step_no: int, batch_index: int,
                      sentinel: DivergenceSentinel,
                      seam: dict | None = None) -> None:
        """SIGTERM: check pending steps (never save an update the sentinel
        would reject), save mid-epoch, flush the log, raise Preempted."""
        sentinel.flush()
        # the postmortem captures the ring as of the drained step (it
        # flushes the recorder itself)
        flight.postmortem("preempt", phase=phase, step=step_no)
        self._save_step_ckpt(phase, step_no, batch_index, seam=seam)
        self.log.log("preempt", phase=phase, step=step_no,
                     batch_index=batch_index)
        self.log.flush()
        raise Preempted(
            f"preempted at {phase} step {step_no} "
            f"(epoch {self.epoch + 1}, batch {batch_index}); "
            "checkpoint saved - rerun with train.resume='auto'")

    def _peer_loss_save(self, phase: str, step_no: int, batch_index: int,
                        sentinel: DivergenceSentinel,
                        seam: dict | None = None) -> None:
        """A peer was lost: the epoch has drained to a batch boundary; check
        pending steps, dump a postmortem naming the lost hosts, save
        mid-epoch (the lowest survivor writes, with no barrier on the group
        that lost them), raise PeerLost: the phase loop continues degraded,
        or, strict, the caller restarts with resume="auto"."""
        sentinel.flush()
        # the lost hosts before the dump: the fleet merge reads them from
        # the bundle's meta
        lost = self.health.lost()
        flight.postmortem("peer_loss", phase=phase, step=step_no, lost=lost)
        self._save_step_ckpt(phase, step_no, batch_index, seam=seam,
                             barrier=False)
        obs.counter("resilience.peer_loss_drain").inc()
        self.log.log("peer_loss_drain", phase=phase, step=step_no,
                     batch_index=batch_index, lost=lost)
        self.log.flush()
        raise PeerLost(
            lost,
            f"lost host(s) {lost} at {phase} step {step_no} "
            f"(epoch {self.epoch + 1}, batch {batch_index}); drained and "
            "saved - continuing degraded or restart with "
            "train.resume='auto'")

    def _peer_lost(self) -> bool:
        return self.health is not None and self.health.peer_lost

    def _collective_failed(self, err: BaseException, phase: str,
                           step_no: int, batch_index: int,
                           sentinel: DivergenceSentinel) -> None:
        """A collective raised (gloo: a peer closed the connection): a
        peer loss if the monitor confirms one within its detection window
        (``peer_timeout_s * health_misses`` plus one interval), and then
        the epoch drains as for a polled loss, the step in flight not
        applied (its update comes after its reductions). Otherwise, and
        for anything but a collective's error, ``err`` stands."""
        if not isinstance(err, RuntimeError) or isinstance(err, _CONTROL) \
                or self.health is None or not self._real_ranks:
            raise err
        t = self.cfg.train
        window = t.peer_timeout_s * t.health_misses + t.health_interval_s
        deadline = time.monotonic() + window
        while not self.health.peer_lost:
            if time.monotonic() > deadline:
                raise err
            time.sleep(min(0.01, t.health_interval_s / 4))
        self.log.log("collective_peer_loss", phase=phase, step=step_no,
                     batch_index=batch_index, lost=self.health.lost(),
                     error=type(err).__name__, detail=str(err)[:200])
        self._peer_loss_save(phase, step_no, batch_index, sentinel)

    def _apply_rollback(self, phase: str, err: RollbackRequested,
                        sentinel: DivergenceSentinel) -> None:
        """Restore the newest verifiable checkpoint and salt the data
        order, within ``train.max_rollbacks``."""
        self._rollbacks += 1
        # no postmortem here: the sentinel dumped the ring at the divergence
        obs.counter("resilience.rollback").inc()
        if self._rollbacks > self.cfg.train.max_rollbacks:
            raise TrainingDiverged(
                f"rollback budget exhausted ({self.cfg.train.max_rollbacks})"
                f" after {phase} divergence: {err}") from err
        restored = self.ckpt.restore_latest(self.state)
        if restored is None:
            raise TrainingDiverged(
                f"{phase} diverged with no checkpoint to roll back to: "
                f"{err}") from err
        state, infos = restored
        self.state = self._replicate(state)
        self.epoch = int(infos.get("epoch", 0))
        self.xe_epochs = int(infos.get("xe_epochs", self.epoch))
        self.rl_epochs = int(infos.get("rl_epochs", 0))
        # the epoch restarts at batch 0 under the new salt: a saved
        # batch_index or seam names batches of the old order
        self._resume_batch = self._resume_rl_batch = 0
        self._pending_seam = None
        self.batcher.salt = self._rollbacks
        if self._rl_batcher is not None:
            self._rl_batcher.salt = self._rollbacks
        sentinel.reset()
        self.log.log("rollback", phase=phase, step=err.step, kind=err.kind,
                     restored_step=infos.get("global_step"),
                     restored_epoch=self.epoch, salt=self._rollbacks)

    # ---- elastic: the degraded mesh and its grow-back -------------------------

    def _surviving_devices(self, survivors: list[int], devices=None,
                           hosts: int | None = None) -> list:
        """The devices of ``survivors``, in the original order (the JAX
        trainer's arithmetic). On real ranks a device is its host's id;
        simulated hosts split this process's device list evenly, host k
        the k-th contiguous chunk. The default base is the current layout;
        a regrow passes the original one, so a re-admitted host's share
        comes back in its place."""
        devices = self._all_mesh_devices if devices is None else devices
        hosts = self._initial_hosts if hosts is None else hosts
        if self._real_ranks:
            alive = set(survivors)
            return [d for d in devices if d in alive]
        per_host = max(1, len(devices) // hosts)
        out = []
        for h in survivors:
            out.extend(devices[h * per_host:(h + 1) * per_host])
        return out

    def _regroup(self, members: list[int], generation: int) -> None:
        """Make ``members`` the group (real ranks: a new process group,
        ``multihost.regroup``) and rebuild the mesh over it, with this
        host's share of every batch."""
        if self._real_ranks:
            self.rank, self.world = multihost.regroup(
                members, self.host_id, generation, store_dir=self.health.dir)
        self.mesh = make_mesh(0, device=self.device)
        self._members = list(members)
        if self._real_ranks:
            self.batcher = self._rebuild_batcher(self.batcher,
                                                 self._host_shard())

    def _restore_drain(self, what: str) -> tuple:
        """The drain save every member continues from, by name: the
        lowest live host wrote it, and a member that has no name for it (a
        rejoiner) takes the first one in rank order. A rejoiner never
        trusts a checkpoint of its own."""
        name = self._last_step_ckpt
        if self.world > 1:
            name = next((n for n in multihost.allgather_pyobj(name)
                         if n is not None), None)
        restored = (self.ckpt.restore_latest(self.state, prefer=name)
                    if name is not None else None)
        if restored is None or restored[1].get("ckpt_name") != name:
            raise RuntimeError(
                f"{what} found no drain save {name!r} in "
                f"{self.cfg.train.ckpt_dir}")
        self._last_step_ckpt = name
        return restored

    def _continue_degraded(self, phase: str, err: PeerLost) -> None:
        """Continue after a drained peer loss: rendezvous the survivors,
        regroup them (real ranks) into a shrunk 1-D data mesh over the
        surviving devices, restore the drain save by name on every
        survivor (the batch index and seam with it), rebuild the
        mesh-shaped pieces (gradient reducer, XE step, evaluator, batch
        share), and let the phase loop replay the rest of the epoch on the
        same global batch."""
        cfg = self.cfg
        if self.health is None or self._all_mesh_devices is None:
            raise err  # the continuation needs the monitor and a mesh
        if self._real_ranks and phase == "rl" \
                and cfg.train.rl_topology == "decoupled":
            raise RuntimeError(
                "degraded-mesh continuation does not support a real lost "
                "peer during a split (decoupled across ranks) RL epoch: its "
                "boundary exchange holds the dead rank; run the decoupled "
                "topology with elastic='strict'") from err
        t0 = time.perf_counter()
        self._degraded_gen += 1
        gen = self._degraded_gen
        expected = self.health.survivors()
        with obs.span("degraded_rendezvous", generation=gen):
            survivors = health_mod.rendezvous(
                self.health.dir, host_id=self.health.host_id, hosts=expected,
                generation=gen,
                timeout_s=max(cfg.train.peer_timeout_s * 4.0, 1.0))
        t1 = time.perf_counter()
        devices = self._surviving_devices(survivors)
        n_data = len(devices)
        if n_data == 0:
            raise RuntimeError(
                f"no devices survive the loss of host(s) {err.hosts}"
            ) from err
        if cfg.data.batch_size % n_data:
            raise RuntimeError(
                f"cannot continue degraded: global batch_size "
                f"{cfg.data.batch_size} is not divisible by the {n_data} "
                "surviving devices - run elastic='strict' or pick a batch "
                "size divisible by every survivable mesh width") from err
        if self._real_ranks and self._is_writer():
            # the generation first: a restarted host that finds its
            # tombstone reads it to ask for the next one
            health_mod.publish_generation(self.health.dir, gen, survivors)
            for victim in err.hosts:
                self.health.mark_dead(victim)
        self._regroup(survivors, gen)
        t2 = time.perf_counter()
        state, infos = self._restore_drain("degraded continuation")
        batch_index, res_phase = self._adopt_restored(
            state, infos, cfg.train.ckpt_dir)
        t3 = time.perf_counter()
        self._build_xe_step()
        self._build_validator()
        self.health.set_membership(survivors)
        self.health.acknowledge()
        # rejoin markers for the next regrow carry generation + 1
        self.health.generation = gen
        self._all_mesh_devices = devices
        self._initial_hosts = len(survivors)
        obs.counter("resilience.degraded_continuation").inc()
        obs.event("degraded_mesh", phase=phase, lost=err.hosts,
                  survivors=survivors, devices=n_data)
        # the fleet timeline pairs shrink -> regrow arcs, one a victim
        for victim in err.hosts:
            obs.event("mesh_shrink", phase=phase, victim=victim,
                      devices=n_data, generation=gen)
        self.log.log("degraded_mesh", phase=phase, lost=err.hosts,
                     survivors=survivors, devices=n_data,
                     global_batch=cfg.data.batch_size,
                     resumed_phase=res_phase,
                     resumed_batch_index=batch_index)
        self.log.log("elastic_times", kind="shrink", generation=gen,
                     rendezvous_ms=(t1 - t0) * 1e3,
                     regroup_ms=(t2 - t1) * 1e3,
                     restore_ms=(t3 - t2) * 1e3, world=self.world)

    def _poll_rejoin(self) -> None:
        """The batch-boundary rejoin poll: free unless the run is degraded
        with ``elastic_regrow`` (a few attribute reads); then it visits the
        ``health.rejoin`` chaos point and scans for rejoin markers. A
        validated rejoiner is admitted at the next drained boundary
        (``_regrow_host``); a refused one's marker is consumed and the run
        goes on as it was. Across several live ranks the lowest scans and
        its answer is every rank's."""
        h = self.health
        if (h is None or self._regrow_host is not None
                or self.cfg.train.elastic != "degraded"
                or not self.cfg.train.elastic_regrow
                or self._original_mesh_devices is None
                or not (h.lost_hosts or len(self._members) < self._hosts
                        and self._real_ranks)
                or h.peer_lost):  # an unacknowledged loss outranks a rejoin
            return
        chaos.visit("health.rejoin")
        host = None
        if self.rank == 0:
            pending = h.pending_rejoins()
            if pending:
                host = min(pending)  # a fixed order when several announce
                gen = self._degraded_gen + 1
                try:
                    health_mod.attempt_rejoin(h, host, gen)
                except health_mod.RejoinRefused as e:
                    h.clear_rejoin(host)
                    obs.event("rejoin_refused", host=host, generation=gen)
                    self.log.log("rejoin_refused", host=host,
                                 generation=gen, detail=str(e))
                    host = None
        if self.world > 1:
            host = multihost.broadcast_pyobj(host)
        self._regrow_host = host

    def _regrow_save(self, phase: str, step_no: int, batch_index: int,
                     sentinel: DivergenceSentinel,
                     seam: dict | None = None) -> None:
        """A validated rejoiner waits: drain at the batch boundary as for a
        peer loss (on a whole group, so the seam is kept), save, and raise
        ``HostRejoin`` to the phase loop, which runs the regrow."""
        host = self._regrow_host
        sentinel.flush()
        self._save_step_ckpt(phase, step_no, batch_index, seam=seam,
                             barrier=False)
        obs.counter("resilience.regrow_drain").inc()
        self.log.log("regrow_drain", phase=phase, step=step_no,
                     batch_index=batch_index, rejoiner=host)
        self.log.flush()
        raise health_mod.HostRejoin(
            host,
            f"host {host} re-admission scheduled at {phase} step {step_no} "
            f"(epoch {self.epoch + 1}, batch {batch_index}); drained and "
            "saved")

    def _continue_regrown(self, phase: str,
                          err: health_mod.HostRejoin) -> bool:
        """The grow-back, the inverse of :meth:`_continue_degraded`: the
        survivors and the rejoiner rendezvous at the next generation, the
        group (real ranks) and the mesh are rebuilt over every live host
        from the original layout, every member restores the survivors'
        regrow drain save by name and ``replicate`` makes it theirs, and
        the phase loop replays the rest of the epoch, seam included. ->
        whether the host was admitted. A rendezvous that times out (a
        flaky rejoiner) or a grown world that does not divide the batch
        refuses it: the run goes on degraded from the same save, as it
        would have without the rejoin."""
        cfg = self.cfg
        host = err.host
        self._regrow_host = None
        gen = self._degraded_gen + 1
        members = sorted(set(self.health.survivors()) | {host})
        devices = self._surviving_devices(
            members, devices=self._original_mesh_devices,
            hosts=self._original_hosts)
        n_data = len(devices)
        admitted = False
        refuse_reason = ""
        t0 = time.perf_counter()
        if cfg.data.batch_size % n_data:
            refuse_reason = (
                f"global batch_size {cfg.data.batch_size} is not divisible "
                f"by the {n_data} regrown devices")
        else:
            try:
                with obs.span("regrow_rendezvous", generation=gen):
                    health_mod.rendezvous(
                        self.health.dir, host_id=self.health.host_id,
                        hosts=members, generation=gen,
                        timeout_s=max(cfg.train.peer_timeout_s * 2.0, 0.5))
                admitted = True
            except health_mod.RendezvousTimeout as e:
                # the flaky rejoiner: announced, validated, then gone
                # before it checked in
                refuse_reason = str(e)
        t1 = time.perf_counter()
        if admitted:
            if self._real_ranks and self._is_writer():
                health_mod.publish_generation(self.health.dir, gen, members)
            self._regroup(members, gen)
            self.health.readmit(host)
            self.health.set_membership(members)
            self._degraded_gen = gen
            self.health.generation = gen
            self._all_mesh_devices = devices
            self._initial_hosts = len(members)
        else:
            obs.counter("resilience.regrow.refused").inc()
            self.health.clear_rejoin(host)
            obs.event("regrow_refused", phase=phase, rejoiner=host,
                      generation=gen)
            self.log.log("regrow_refused", phase=phase, rejoiner=host,
                         generation=gen, detail=refuse_reason)
        t2 = time.perf_counter()
        # the survivors' state: the regrow drain saved it moments ago, and
        # restoring it by name onto the mesh (grown, or as it was) re-arms
        # the mid-epoch resume (batch index and seam) either way
        state, infos = self._restore_drain("regrow continuation")
        batch_index, res_phase = self._adopt_restored(
            state, infos, cfg.train.ckpt_dir)
        t3 = time.perf_counter()
        if admitted:
            self._build_xe_step()
            self._build_validator()
            obs.counter("resilience.regrow.admitted").inc()
            obs.event("mesh_regrow", phase=phase, rejoiner=host,
                      devices=n_data, generation=gen)
            self.log.log("mesh_regrow", phase=phase, rejoiner=host,
                         hosts=members, devices=n_data, generation=gen,
                         global_batch=cfg.data.batch_size,
                         resumed_phase=res_phase,
                         resumed_batch_index=batch_index)
            self.log.log("elastic_times", kind="regrow", generation=gen,
                         rendezvous_ms=(t1 - t0) * 1e3,
                         regroup_ms=(t2 - t1) * 1e3,
                         restore_ms=(t3 - t2) * 1e3, world=self.world)
        return admitted

    def _rebuild_batcher(self, old: Batcher,
                         host_shard: tuple[int, int]) -> Batcher:
        """The same data order (epoch index and salt) at a new host
        share."""
        new = Batcher(self.train_ds, batch_size=old.batch_size,
                      max_len=old.max_len, mode=old.mode,
                      seq_per_vid=old.seq_per_vid, seed=old.seed,
                      host_shard=host_shard)
        new.epoch_index = old.epoch_index
        new.salt = old.salt
        return new

    def _join_next_generation(self) -> None:
        """A restarted host's side of a regrow: ask for the generation
        after the survivors' last one (``generation.json``), wait in its
        rendezvous for the survivors' next drained boundary, and join its
        group. The survivors' drain save is restored after the rest of the
        setup (:meth:`_adopt_rejoin`)."""
        h = self.health
        cur = health_mod.read_generation(h.dir)
        gen = cur["generation"] + 1
        members = sorted(set(cur["hosts"]) | {self.host_id})
        h.announce_rejoin(gen)
        self.log.log("rejoin_announced", host=self.host_id, generation=gen,
                     hosts=members)
        t0 = time.perf_counter()
        with obs.span("regrow_rendezvous", generation=gen):
            health_mod.rendezvous(h.dir, host_id=self.host_id, hosts=members,
                                  generation=gen,
                                  timeout_s=multihost.timeout_s())
        t1 = time.perf_counter()
        self.rank, self.world = multihost.regroup(
            members, self.host_id, gen, store_dir=h.dir)
        self._rejoin_times = {"rendezvous_ms": (t1 - t0) * 1e3,
                              "regroup_ms": (time.perf_counter() - t1) * 1e3}
        h.set_membership(members)
        h.generation = gen
        self._degraded_gen = gen
        self._members = members

    def _adopt_rejoin(self) -> None:
        """The rejoiner takes the survivors' regrow drain save by name,
        and ``replicate`` makes the writer's state its own."""
        t0 = time.perf_counter()
        state, infos = self._restore_drain("rejoin")
        batch_index, phase = self._adopt_restored(state, infos,
                                                  self.cfg.train.ckpt_dir)
        self.rejoined = True
        self.log.log("rejoined", host=self.host_id,
                     generation=self._degraded_gen, hosts=self._members,
                     rank=self.rank, world=self.world,
                     resumed_phase=phase or "epoch_end",
                     resumed_batch_index=batch_index,
                     restore_ms=(time.perf_counter() - t0) * 1e3,
                     **self._rejoin_times)

    # ---- XE ----------------------------------------------------------------------

    def train_xe(self, epochs: int | None = None) -> float | None:
        """The XE/WXE phase -> the last validation CIDEr-D.

        ``epochs=None`` takes ``train.epochs`` as the phase total (a
        resumed run trains the rest); a number trains that many more.
        Raises :class:`Preempted` after a SIGTERM save,
        :class:`PeerLost` after a peer-loss save (``elastic="strict"``)
        and :class:`TrainingDiverged` under ``abort`` or past the rollback
        budget."""
        cfg = self.cfg
        if epochs is None:
            epochs = max(0, cfg.train.epochs - self.xe_epochs)
        if epochs == 0:
            return None
        target = self.xe_epochs + epochs
        meter = obs.StepMeter("xe")
        profiler = self._profiler("xe")
        sentinel = self._make_sentinel("xe")
        last_val = None
        run = {"first_step": True}   # the meter's first-step exclusion
        with PreemptionHandler() as pre:
            while self.xe_epochs < target:
                try:
                    last_val = self._xe_epoch(meter, profiler, sentinel, pre,
                                              run)
                except RollbackRequested as e:
                    self._apply_rollback("xe", e, sentinel)
                except PeerLost as e:
                    # strict ends the run (its drain save resumes bitwise
                    # on the full mesh); degraded goes on with the survivors
                    if cfg.train.elastic != "degraded":
                        raise
                    self._continue_degraded("xe", e)
                    run["first_step"] = True
                except health_mod.HostRejoin as e:
                    if self._continue_regrown("xe", e):
                        run["first_step"] = True
        return last_val

    def _profiler(self, phase: str) -> StepProfiler:
        cfg = self.cfg.train
        return StepProfiler(
            os.path.join(cfg.profile_dir, phase) if cfg.profile_dir else "",
            cfg.profile_steps, log=self.log.log)

    def _xe_epoch(self, meter, profiler, sentinel, pre, run) -> float | None:
        """One XE epoch (or the rest of one): steps, sentinel, mid-epoch
        saves, then validation and the epoch checkpoint."""
        cfg = self.cfg
        log_every = cfg.train.log_every_steps
        ckpt_every = cfg.train.ckpt_every_steps
        self.batcher.epoch_index = self.xe_epochs
        skip = self._resume_batch
        self._resume_batch = 0
        batch_no = skip
        step_no = int(self.state.step)
        losses, times = [], []
        if obs.enabled():
            obs.set_context(phase="xe", epoch=self.epoch + 1)
        meter.begin_epoch()
        stop = threading.Event()
        # xe.step spans cover the loop body; the xe.epoch span's self time
        # is the wait on the input pipeline
        with obs.span("xe.epoch"):
            try:
                t_prev = time.perf_counter()
                for arrays in self._device_batches(self.batcher, skip=skip,
                                                   stop_event=stop):
                    with obs.span("xe.step"):
                        feats, masks, labels, mask, weights, valid = arrays
                        w = xe_row_weights(cfg.train.loss, weights, valid)
                        try:
                            self.state, m = self.xe_step(
                                self.state, feats, masks, labels, mask, w)
                        except RuntimeError as e:
                            self._collective_failed(e, "xe", step_no,
                                                    batch_no, sentinel)
                        losses.append(m["loss"])
                        # record before push: a sentinel trip's postmortem
                        # flushes, so the ring holds the diverged step
                        flight.record(step_no + 1, "xe", m)
                        sentinel.push(step_no + 1, m["loss"],
                                      m.get("nonfinite"))
                        step_no += 1
                        batch_no += 1
                        now = time.perf_counter()
                        times.append(now - t_prev)
                        t_prev = now
                        if obs.enabled():
                            obs.set_context(step=step_no)
                        if log_every and step_no % log_every == 0:
                            self.log.log("xe_step", phase="xe", step=step_no,
                                         epoch=self.epoch + 1,
                                         loss=m["loss"],
                                         grad_norm=m["grad_norm"])
                            # the same cadence: one readback drains the
                            # recorder
                            flight.flush()
                        obs.maybe_snapshot(step_no)
                        profiler.tick()
                        meter.tick(cfg.data.batch_size,
                                   first=run["first_step"])
                        run["first_step"] = False
                        obs.counter("flops.xe.step").inc(
                            self._xe_flops_inc(
                                self.batcher.local_batch_size))
                        chaos.visit("xe.step")
                        if self.health is not None:
                            self.health.note_step(step_no)
                        if pre.requested:
                            self._preempt_save("xe", step_no, batch_no,
                                               sentinel)
                        if self._peer_lost():
                            self._peer_loss_save("xe", step_no, batch_no,
                                                 sentinel)
                        self._poll_rejoin()
                        if self._regrow_host is not None:
                            self._regrow_save("xe", step_no, batch_no,
                                              sentinel)
                        if ckpt_every and step_no % ckpt_every == 0:
                            flight.flush()
                            sentinel.flush()   # never save a rejected update
                            self._save_step_ckpt("xe", step_no, batch_no)
            finally:
                stop.set()
            profiler.stop()
            # a SIGTERM between the last step and here must not let the
            # counters pass the saved state
            if pre.requested:
                self._preempt_save("xe", step_no, batch_no, sentinel)
            if self._peer_lost():
                self._peer_loss_save("xe", step_no, batch_no, sentinel)
            self._poll_rejoin()
            if self._regrow_host is not None:
                self._regrow_save("xe", step_no, batch_no, sentinel)
            flight.flush()
            sentinel.flush()
        self.epoch += 1
        self.xe_epochs += 1
        vals = np.asarray(losses, np.float64)
        vals = vals[np.isfinite(vals)]  # guard-skipped steps
        clips_s, step_ms = _rate(cfg.data.batch_size, times)
        self.log.log("xe_epoch", epoch=self.epoch,
                     loss=float(vals.mean()) if vals.size else float("nan"),
                     steps=len(times), clips_per_s=clips_s,
                     step_ms_median=step_ms)
        obs.snapshot_metrics(epoch=self.epoch)
        return self._validate_and_checkpoint("xe", step_no, sentinel)

    # ---- RL ----------------------------------------------------------------------

    def train_rl(self, epochs: int | None = None) -> float | None:
        """The CST/SCST phase (``cfg.rl``) -> the last validation CIDEr-D.

        ``epochs=None``: ``rl.epochs`` is the phase total. At the handoff
        (no RL step taken yet) the optimizer starts fresh at ``rl.lr``
        with step 0; a mid-RL resume keeps the restored Adam moments and
        checks that their structure fits the RL optimizer. A SIGTERM (or a
        peer loss) stops the epoch at a batch boundary and the pipeline
        drains in schedule order; the save records the batch index and,
        pipelined, the seam's tokens, so both modes resume to the
        uninterrupted run.
        """
        cfg = self.cfg
        if epochs is None:
            epochs = max(0, cfg.rl.epochs - self.rl_epochs)
        if epochs == 0:
            return None
        rl_setup = obs.span("setup", phase="rl").begin()
        tx = make_optimizer(cfg.train, self.steps_per_epoch,
                            lr_override=cfg.rl.lr)
        fresh = tx.init([p.detach() for p in self.state.params])
        # the handoff: no RL step taken yet. The JAX trainer tests
        # rl_epochs alone, which also resets a resume from inside the
        # first RL epoch
        if self.rl_epochs == 0 and not self._resume_rl_batch:
            self.state.step = 0
            self.state.opt_state = fresh
        else:
            got = self.state.opt_state
            if set(fresh) != set(got) or any(
                    [tuple(t.shape) for t in fresh[k]]
                    != [tuple(t.shape) for t in got[k]]
                    for k in fresh if k != "count"):
                raise RuntimeError(
                    "mid-RL resume: the checkpoint's optimizer state does "
                    "not match the RL optimizer built from this config - "
                    "the restored Adam moments would be misread. Did the "
                    "optimizer definition change between runs?")
        self.state.tx = tx

        df = CorpusDF.load(cfg.data.cider_df) if cfg.data.cider_df else None
        self.reward = RewardComputer(
            self.train_ds.vocab, self.train_ds.gts_pool(), df=df,
            cider_weight=cfg.rl.reward_cider_weight,
            bleu_weight=cfg.rl.reward_bleu4_weight,
            bleu_scale=cfg.rl.reward_bleu4_scale,
            num_threads=cfg.rl.reward_threads)
        scst, rl_batcher = self._build_scst()
        target = self.rl_epochs + epochs
        meter = obs.StepMeter("rl")
        profiler = self._profiler("rl")
        sentinel = self._make_sentinel("rl")
        last_val = None
        run = {"first_step": True}
        rl_setup.end()
        try:
            with PreemptionHandler() as pre:
                while self.rl_epochs < target:
                    try:
                        last_val = self._rl_epoch(scst, rl_batcher, meter,
                                                  profiler, sentinel, pre,
                                                  run)
                    except RollbackRequested as e:
                        self._apply_rollback("rl", e, sentinel)
                    except PeerLost as e:
                        if cfg.train.elastic != "degraded":
                            raise
                        self._continue_degraded("rl", e)
                        # the decode and update hold the mesh, the batcher
                        # its share: rebuild them on the shrunk one
                        scst, rl_batcher = self._build_scst()
                        run["first_step"] = True
                    except health_mod.HostRejoin as e:
                        if self._continue_regrown("rl", e):
                            scst, rl_batcher = self._build_scst()
                            run["first_step"] = True
        finally:
            self._rl_batcher = None
        return last_val

    def _build_scst(self):
        """The RL epoch's trainer and batcher for the current mesh (the JAX
        trainer's ``build_scst``): at the phase's start and after every
        shrink or regrow."""
        cfg = self.cfg
        if cfg.train.rl_topology == "decoupled":
            # the actor/learner ring schedule (rl/async_scst.py), split
            # across the ranks of a mesh
            scst = AsyncSCSTTrainer(
                self.model, self.reward, cfg.rl, max_len=cfg.model.max_len,
                guard=self.guard, stats=self._stats,
                batch_size=cfg.data.batch_size, mesh=self.mesh,
                comm=self.comm, on_event=self.log.log)
            if scst.plan is not None:
                self.log.log("rl_split", actors=list(scst.plan.actor_ranks),
                             learners=list(scst.plan.learner_ranks),
                             shared=scst.plan.shared)
        else:
            scst = SCSTTrainer(self.model, self.reward, cfg.rl,
                               max_len=cfg.model.max_len, guard=self.guard,
                               stats=self._stats, on_event=self.log.log,
                               mesh=self.mesh, comm=self.comm)
        # a split epoch takes the global batch on every rank and slices it
        # by role
        split = cfg.train.rl_topology == "decoupled" \
            and self.mesh is not None and self.mesh.world > 1
        rl_batcher = Batcher(
            self.train_ds, batch_size=cfg.data.batch_size,
            max_len=cfg.model.max_len, mode="video",
            seed=cfg.data.shuffle_seed,
            host_shard=(0, 1) if split else self._host_shard())
        rl_batcher.salt = self.batcher.salt
        self._rl_batcher = rl_batcher
        return scst, rl_batcher

    def _rl_epoch(self, scst, rl_batcher, meter, profiler, sentinel, pre,
                  run) -> float | None:
        """One RL epoch (or the rest of one)."""
        cfg = self.cfg
        log_every = cfg.train.log_every_steps
        # keyed by the global epoch, so a resumed RL phase replays the
        # uninterrupted run's order
        rl_batcher.epoch_index = self.epoch
        skip = self._resume_rl_batch
        self._resume_rl_batch = 0
        seam = None
        seam_capable = (cfg.rl.pipelined
                        or cfg.train.rl_topology == "decoupled")
        if skip and self._pending_seam is not None:
            cand, self._pending_seam = self._pending_seam, None
            if seam_capable and cand["epoch"] == self.epoch \
                    and cand["batch_index"] == skip:
                seam = cand
            else:
                self.log.log("seam_discarded", epoch=self.epoch,
                             batch_index=skip, seam_epoch=cand["epoch"],
                             seam_batch_index=cand["batch_index"])
        epoch, salt, base = self.epoch, self.batcher.salt, cfg.train.seed + 1

        def seeds(j):
            return rollout_seed(base, salt, epoch, skip + j)

        counter = {"step": int(self.state.step), "n": skip}
        rewards, valid_rows, times = [], [], []
        t_prev = [time.perf_counter()]
        if obs.enabled():
            obs.set_context(phase="rl", epoch=self.epoch + 1)
        meter.begin_epoch()

        def on_step(m):
            rewards.append(m["reward_mean"])
            valid_rows.append(m["valid_rows"])
            counter["step"] += 1
            counter["n"] += 1
            now = time.perf_counter()
            times.append(now - t_prev[0])
            t_prev[0] = now
            # record before push (see _xe_epoch)
            flight.record(counter["step"], "rl", m)
            sentinel.push(counter["step"], m["rl_loss"], m.get("nonfinite"))
            if obs.enabled():
                obs.set_context(step=counter["step"])
            if log_every and counter["step"] % log_every == 0:
                self.log.log("rl_step", phase="rl", step=counter["step"],
                             epoch=self.epoch + 1, reward=m["reward_mean"],
                             rl_loss=m["rl_loss"], grad_norm=m["grad_norm"],
                             decode_steps=m["decode_steps"])
                flight.flush()
            obs.maybe_snapshot(counter["step"])
            profiler.tick()
            meter.tick(cfg.data.batch_size, first=run["first_step"])
            run["first_step"] = False
            chaos.visit("rl.step")
            if self.health is not None:
                self.health.note_step(counter["step"])
            self._poll_rejoin()

        stop = threading.Event()
        seam_sink: dict = {}
        # a lost peer on real ranks: the drain enters no collective of the
        # group that held it (rl/scst.py, ``abandon``)
        kw = ({"abandon": lambda: self._real_ranks and self._peer_lost()}
              if not isinstance(scst, AsyncSCSTTrainer) else {})
        # the rl.epoch span's self time is what the decode, reward and
        # update spans inside train_epoch do not claim: input waits, drains
        with obs.span("rl.epoch"):
            try:
                self.state, _ = scst.train_epoch(
                    self.state,
                    self._rl_device_batches(rl_batcher, skip=skip,
                                            stop_event=stop),
                    seeds, on_step=on_step, pipelined=cfg.rl.pipelined,
                    should_stop=lambda: (pre.requested or self._peer_lost()
                                         or self._regrow_host is not None),
                    seam=seam,
                    seam_sink=seam_sink if seam_capable else None, **kw)
            except RuntimeError as e:
                # the update in flight raised in its all-reduce: it was
                # not applied, and its save carries no seam
                self._collective_failed(e, "rl", counter["step"],
                                        counter["n"], sentinel)
            finally:
                stop.set()
            profiler.stop()
            # a decoupled epoch across ranks stops every rank when any one
            # asks: a rank whose peer was preempted saves with it
            agreed = isinstance(scst, AsyncSCSTTrainer) and \
                scst.last_stopped and not self._peer_lost() \
                and self._regrow_host is None
            if pre.requested or agreed:
                self._preempt_save("rl", counter["step"], counter["n"],
                                   sentinel, seam=seam_sink or None)
            if self._peer_lost():
                self._peer_loss_save("rl", counter["step"], counter["n"],
                                     sentinel, seam=seam_sink or None)
            if self._regrow_host is not None:
                self._regrow_save("rl", counter["step"], counter["n"],
                                  sentinel, seam=seam_sink or None)
            flight.flush()
            sentinel.flush()
        self.epoch += 1
        self.rl_epochs += 1
        n_valid = float(np.sum(valid_rows)) if valid_rows else 0.0
        clips_s, step_ms = _rate(cfg.data.batch_size, times)
        try:
            # each rank scores its own rows: weight by valid rows and
            # reduce across the ranks exactly
            reward = multihost.global_weighted_mean(
                float(np.dot(rewards, valid_rows)) if valid_rows else 0.0,
                n_valid)
        except RuntimeError as e:
            self._collective_failed(e, "rl", counter["step"], 0, sentinel)
        self.log.log("rl_epoch", epoch=self.epoch, reward=reward,
                     steps=len(times), clips_per_s=clips_s,
                     step_ms_median=step_ms)
        obs.snapshot_metrics(epoch=self.epoch)
        return self._validate_and_checkpoint("rl", counter["step"], sentinel)

    # ---- validation ----------------------------------------------------------------

    def _validate_and_checkpoint(self, phase: str, step_no: int,
                                 sentinel: DivergenceSentinel
                                 ) -> float | None:
        """Validation (every rank: the sharded decode), the epoch
        checkpoint (the lowest live host writes) and a barrier that keeps
        the others from running ahead of it. A peer lost in either
        exchange drains as an epoch-end save (batch index 0)."""
        value = None
        try:
            if self.validator is not None and (
                    self.epoch % self.cfg.train.eval_every_epochs == 0):
                t0 = time.perf_counter()
                result = self.validator.evaluate()
                value = result["metrics"].get("CIDEr-D")
                self.log.log("validate", epoch=self.epoch, cider_d=value,
                             ms=(time.perf_counter() - t0) * 1e3)
            if self._is_writer():
                with obs.span("ckpt", kind="epoch"):
                    is_best = self.ckpt.save(
                        self.state, value,
                        infos=self._ckpt_infos(step_no=step_no))
                self.log.log("ckpt_epoch", epoch=self.epoch, best=is_best,
                             **self.ckpt.last_save)
                if is_best:
                    self.log.log("new_best", epoch=self.epoch,
                                 cider_d=value)
            multihost.barrier("ckpt.save")
        except RuntimeError as e:
            self._collective_failed(e, phase, step_no, 0, sentinel)
        return value
