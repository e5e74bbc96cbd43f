"""SIGTERM handling for the train loops (the JAX package's
``resilience/preempt.py``).

The handler only sets a flag; the step loop reads it once a step, saves a
mid-epoch checkpoint that records the batch index, and raises
:class:`Preempted`, so the next run with ``train.resume="auto"`` trains
the rest of the epoch.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class Preempted(RuntimeError):
    """Raised by a train loop after a preemption-triggered save."""


class PreemptionHandler:
    """A SIGTERM latch; as a context manager it restores the previous
    handlers. ``signal.signal`` works only in the main thread, so
    elsewhere it installs nothing (``installed`` stays False)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.installed = False
        self._requested = threading.Event()
        self._prev: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def _on_signal(self, signum, frame) -> None:
        self._requested.set()
        prev = self._prev.get(signum)
        # chain a Python-level handler installed before this one; never
        # SIG_DFL, whose SIGTERM would kill the process before the save
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)

    def install(self) -> "PreemptionHandler":
        if self.installed:
            return self
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:  # not the main thread
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
