"""Structured JSONL event log with a console echo (the JAX package's
``utils/logging.py``).

Every event is one JSON line ``{"ts", "event", **fields}``; the trainer's
events keep the JAX trainer's names (``xe_epoch``, ``rl_epoch``,
``validate``, ``new_best``, ``resume``, ``handoff``, ``ckpt_step``, ...).
Line-buffered writes, an ``atexit`` close, an fsync'ing :meth:`flush` for
the preemption path, and a context manager that records a final ``crash``
event when the governed block raises.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import time
from typing import IO, Any


class EventLogger:
    def __init__(self, path: str = "", echo: bool = True):
        self._fh: IO | None = None
        self._atexit_close = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
            self._atexit_close = self.close
            atexit.register(self._atexit_close)
        self.echo = echo

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
        if self.echo:
            kv = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            sys.stderr.write(f"[{event}] {kv}\n")

    def flush(self) -> None:
        """Push buffered events to the OS and fsync them."""
        if self._fh:
            self._fh.flush()
            try:
                os.fsync(self._fh.fileno())
            except OSError:
                pass  # a pipe or pty: flush() already did it

    def close(self) -> None:
        if self._atexit_close is not None:
            atexit.unregister(self._atexit_close)
            self._atexit_close = None
        if self._fh:
            self.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.log("crash", error=exc_type.__name__, detail=str(exc))
        self.close()
        return False
