"""Background host-to-device prefetch (the JAX package's
``data/prefetch.py``).

A daemon thread collates upcoming batches and stages them on the device
while the current step runs. On CUDA the thread copies each numpy leaf
into pinned host memory, issues a non-blocking copy on a side stream and
records an event; the consumer's stream waits on that event before it
touches the tensors, and ``record_stream`` tells the caching allocator
that the consumer's stream uses them, so their memory is not handed out
again while that stream's work is queued. On the CPU it is a thread and a
queue.

Items are trees of dicts and tuples; numpy leaves are placed, and every
other leaf (a list of video ids, a Python number) passes through as is.

Observability: each item's collate and copy issue run in a
``prefetch.stage`` span on the worker thread's own track (the report lists
it under overlapped work), observed into the ``prefetch.stage_seconds``
histogram and counted on ``prefetch.batches``; ``prefetch.queue_depth`` is
the depth the consumer sees (pinned at 0 means an input-bound loop).

Resilience (the JAX package's): the worker visits the chaos points
``prefetch.stage`` (with the item, before ``transform``) and
``prefetch.h2d`` (inside the placement). A transient placement failure
(``TransientIOError``, e.g. a torn copy) redoes the whole placement under a
small retry budget, counted on ``resilience.h2d_retry`` with an
``h2d_retry`` event; the fault is raised before any copy is issued, so a
retry never leaves a half-issued copy or a recorded event behind. A
consumer that waits more than ``stall_warn_s`` on an empty queue (a wedged
worker, a stalled read) logs one ``prefetch_stall`` event and counts
``resilience.prefetch_stall`` once per stall, and keeps waiting.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.device import resolve_device
from cst_captioning_tpu_torch.resilience import chaos
from cst_captioning_tpu_torch.resilience.chaos import TransientIOError
from cst_captioning_tpu_torch.resilience.retry import RetryPolicy, retry_call

# a transient placement failure is redone in place under a tight budget:
# the host item is still there, so placing it again is always safe
_H2D_RETRY = RetryPolicy(max_attempts=3, base_delay=0.01, max_delay=0.1,
                         budget=1.0, retry_on=(TransientIOError,))


def tree_map(fn: Callable[[Any], Any], x: Any) -> Any:
    """Apply ``fn`` to the non-container leaves of dicts and tuples."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(tree_map(fn, v) for v in x)
    return fn(x)


def _tensors(x: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(lambda v: out.append(v) if isinstance(v, torch.Tensor) else None,
             x)
    return out


def place_blocking(x: Any, device) -> Any:
    """Numpy leaves -> tensors on ``device`` with a blocking copy each."""
    dev = torch.device(device)
    return tree_map(
        lambda v: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   if isinstance(v, np.ndarray) else v), x)


class _Staged:
    """A staged item and the event its copy recorded on the side stream."""

    __slots__ = ("item", "event", "host")

    def __init__(self, item, event, host):
        self.item, self.event, self.host = item, event, host


def prefetch_to_device(
    it: Iterable[Any],
    size: int = 2,
    transform: Callable[[Any], Any] | None = None,
    place: bool = True,
    stop_event: threading.Event | None = None,
    device=None,
    stall_warn_s: float = 5.0,
) -> Iterator[Any]:
    """Iterate ``it`` with ``size`` items staged ahead on ``device``
    (default the GPU).

    ``transform`` runs on the worker thread before the copy (a ``Batch``
    -> a tree of numpy arrays). ``place=False`` copies nothing: the
    transform's output is yielded as it is. ``stop_event``, once set,
    makes the worker stop before its next item (the preemption path); what
    is staged already is still yielded. An error in the worker is raised
    in the consumer; a consumer that stops early retires the worker.
    ``stall_warn_s`` is the stall watchdog's wait (0 turns it off).
    """
    dev = resolve_device(device)
    cuda = place and dev.type == "cuda"
    stream = torch.cuda.Stream(device=dev) if cuda else None
    stage_hist = obs.histogram("prefetch.stage_seconds")
    staged = obs.counter("prefetch.batches")
    depth = obs.gauge("prefetch.queue_depth")

    def _stage(x):
        t0 = time.perf_counter()
        with obs.span("prefetch.stage"):
            x = chaos.visit("prefetch.stage", x)
            x = transform(x) if transform is not None else x
            x = retry_call(_h2d, x, policy=_H2D_RETRY, on_retry=_h2d_retry)
        stage_hist.observe(time.perf_counter() - t0)
        staged.inc()
        return x

    def _h2d_retry(info):
        obs.counter("resilience.h2d_retry").inc()
        obs.event("h2d_retry", **info)

    def _h2d(x):
        # before any copy is issued: a failure leaves nothing in flight
        chaos.visit("prefetch.h2d")
        return _place(x)

    def _place(x):
        if not place:
            return x
        if not cuda:
            return _Staged(place_blocking(x, dev), None, None)
        with torch.cuda.stream(stream):
            host = tree_map(
                lambda v: (torch.from_numpy(np.ascontiguousarray(v))
                           .pin_memory() if isinstance(v, np.ndarray) else v),
                x)
            item = tree_map(
                lambda v: (v.to(dev, non_blocking=True)
                           if isinstance(v, torch.Tensor) else v), host)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(item, event, host)

    def _receive(x):
        if not isinstance(x, _Staged):
            return x
        if x.event is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(x.event)
            for t in _tensors(x.item):
                t.record_stream(consumer)
        return x.item

    if size < 1:
        for x in it:
            yield _receive(_stage(x))
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def _put(x) -> bool:
        """``q.put`` that gives up once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for x in it:
                if stop_event is not None and stop_event.is_set():
                    return  # preempting: yield only what is staged
                if not _put(_stage(x)):
                    return  # the consumer has gone
                depth.set(q.qsize())
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            _put(_END)

    def _get():
        """``q.get`` that reports, once per stall, a worker that starves
        the consumer past ``stall_warn_s``."""
        if stall_warn_s <= 0:
            return q.get()
        reported = False
        waited = 0.0
        while True:
            try:
                return q.get(timeout=stall_warn_s)
            except queue.Empty:
                waited += stall_warn_s
                if not reported:
                    reported = True
                    obs.counter("resilience.prefetch_stall").inc()
                    obs.event("prefetch_stall", waited_s=round(waited, 3),
                              queue_depth=q.qsize(),
                              worker_alive=t.is_alive())

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            x = _get()
            # as the consumer sees it: 0 while the worker stages means the
            # loop waits on its input
            depth.set(q.qsize())
            if x is _END:
                if err:
                    raise err[0]
                return
            yield _receive(x)
    finally:
        # the consumer stopped early or failed: retire the worker
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=2.0)
