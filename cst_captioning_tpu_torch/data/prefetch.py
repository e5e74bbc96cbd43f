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
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from cst_captioning_tpu_torch.device import resolve_device


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
) -> Iterator[Any]:
    """Iterate ``it`` with ``size`` items staged ahead on ``device``
    (default the GPU).

    ``transform`` runs on the worker thread before the copy (a ``Batch``
    -> a tree of numpy arrays). ``place=False`` copies nothing: the
    transform's output is yielded as it is. ``stop_event``, once set,
    makes the worker stop before its next item (the preemption path); what
    is staged already is still yielded. An error in the worker is raised
    in the consumer; a consumer that stops early retires the worker.
    """
    dev = resolve_device(device)
    cuda = place and dev.type == "cuda"
    stream = torch.cuda.Stream(device=dev) if cuda else None

    def _stage(x):
        x = transform(x) if transform is not None else x
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
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            x = q.get()
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
