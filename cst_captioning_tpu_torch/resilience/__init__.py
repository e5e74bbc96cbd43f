"""The fault-tolerance layer (the JAX package's ``resilience/``) on one
device:

- :mod:`durable`: fsync'd atomic checkpoint writes and a checksum manifest
  verified on load.
- :mod:`sentinel`: NaN/inf and loss-spike checks over the step loops under
  ``skip_batch``, ``rollback`` or ``abort``; :mod:`adaptive` sets its spike
  bound from the loss EWMA (``train.spike_mode="adaptive"``).
- :mod:`retry`: budgeted, jittered exponential backoff for host I/O
  (checkpoint writes, the RL reward, the prefetch placement).
- :mod:`preempt`: SIGTERM sets a flag; the step loop saves mid-epoch and
  exits.
- :mod:`health`: per-host heartbeats and a peer-loss watchdog, the
  survivors' rendezvous, the validated rejoin protocol, and the DCN-stall
  span around cross-host collectives.
- :mod:`chaos`: seeded fault plans (NaN batches, kills mid-save, transient
  I/O errors, slow or failing reward calls, SIGTERM, slow or partial
  host-to-device copies, wedged prefetch, ENOSPC mid-rotation, serving and
  actor preemption, the partial preemption of a host and its rejoin)
  fired at named points in the hot paths.

The finite-update guard is ``train.state.guarded_apply_gradients``.
"""

from cst_captioning_tpu_torch.resilience.adaptive import AdaptiveThresholds
from cst_captioning_tpu_torch.resilience.chaos import (
    Fault,
    FaultPlan,
    PartialTransferError,
    SimulatedKill,
    TransientIOError,
)
from cst_captioning_tpu_torch.resilience.health import (
    HealthMonitor,
    HostRejoin,
    PeerLost,
    RejoinRefused,
    RendezvousTimeout,
    attempt_rejoin,
    collective_span,
    rendezvous,
    simulate_rejoin,
)
from cst_captioning_tpu_torch.resilience.durable import (
    MANIFEST_FILE,
    CorruptCheckpointError,
    fsync_dir,
    verify_manifest,
    write_bytes_durable,
    write_manifest,
)
from cst_captioning_tpu_torch.resilience.preempt import (
    Preempted,
    PreemptionHandler,
)
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy, retry_call
from cst_captioning_tpu_torch.resilience.sentinel import (
    DivergenceSentinel,
    RollbackRequested,
    TrainingDiverged,
)

__all__ = [
    "MANIFEST_FILE",
    "AdaptiveThresholds",
    "CorruptCheckpointError",
    "DivergenceSentinel",
    "Fault",
    "FaultPlan",
    "HealthMonitor",
    "HostRejoin",
    "PartialTransferError",
    "PeerLost",
    "Preempted",
    "PreemptionHandler",
    "RejoinRefused",
    "RendezvousTimeout",
    "RetryPolicy",
    "RollbackRequested",
    "SimulatedKill",
    "TrainingDiverged",
    "TransientIOError",
    "attempt_rejoin",
    "collective_span",
    "fsync_dir",
    "rendezvous",
    "retry_call",
    "simulate_rejoin",
    "verify_manifest",
    "write_bytes_durable",
    "write_manifest",
]
