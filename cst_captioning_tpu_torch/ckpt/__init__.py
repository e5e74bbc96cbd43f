"""Checkpoints: durable saves in the port's own format, the
best/latest/step_* policy, resume, the XE -> RL handoff, and a reader for
the JAX package's flax msgpack checkpoints."""

from cst_captioning_tpu_torch.ckpt.checkpoint import (
    JAX_STATE_FILE,
    CheckpointManager,
    load_params,
    load_state,
    save_state,
)
from cst_captioning_tpu_torch.resilience.durable import CorruptCheckpointError

__all__ = [
    "JAX_STATE_FILE",
    "CheckpointManager",
    "CorruptCheckpointError",
    "load_params",
    "load_state",
    "save_state",
]
