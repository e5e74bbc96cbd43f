"""Checkpoint durability, retries, the divergence sentinel and SIGTERM
handling (the part of the JAX package's ``resilience/`` that the trainer
runs on one device). The health monitor, elastic meshes, chaos injection
and the adaptive spike bound are not ported."""

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
    "CorruptCheckpointError",
    "DivergenceSentinel",
    "Preempted",
    "PreemptionHandler",
    "RetryPolicy",
    "RollbackRequested",
    "TrainingDiverged",
    "fsync_dir",
    "retry_call",
    "verify_manifest",
    "write_bytes_durable",
    "write_manifest",
]
