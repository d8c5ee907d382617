"""Reads of device values to the host that do not wait where they start.

:func:`host_copies` enqueues copies of device tensors into pinned host
buffers on the current stream and records an event behind them; the host
goes on at once, and reads the buffers once the event has completed, where
the value is first needed.  :class:`DeferredObserver` is a FIFO of such
copies, each fed to an observer in the order they were put once its copy
has landed: the engine's filter-traffic recorder, fed after the batch's
scan is enqueued in place of a read that would wait in the plan for the
batch before it.

A completion is anything with ``query()`` (True once done, no wait) and
``synchronize()`` (waits): a ``torch.cuda.Event``, or :data:`DONE`.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, ContextManager, Optional, Sequence, Tuple

import numpy as np
import torch


class _Done:
    """The completion of a copy that was made at once (a host source)."""

    @staticmethod
    def query() -> bool:
        return True

    @staticmethod
    def synchronize() -> None:
        pass


DONE = _Done()


class HostCopy:
    """Host copies of tensors, valid once ``done`` has completed."""

    __slots__ = ("host", "done")

    def __init__(self, host: Tuple[torch.Tensor, ...], done=DONE):
        self.host = host
        self.done = done

    def ready(self) -> bool:
        return bool(self.done.query())

    def wait(self) -> Tuple[np.ndarray, ...]:
        """Waits for the copies (if they have not landed) and returns them
        as numpy arrays."""
        self.done.synchronize()
        return tuple(h.numpy() for h in self.host)


def host_copies(tensors: Sequence[torch.Tensor]) -> HostCopy:
    """Copies ``tensors`` to the host without a wait: CUDA tensors into
    pinned buffers on the current stream, an event recorded behind them;
    host tensors at once."""
    if not any(t.device.type == "cuda" for t in tensors):
        return HostCopy(tuple(t.detach().clone() for t in tensors))
    bufs = []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        bufs.append(buf)
    done = torch.cuda.Event()
    done.record()
    return HostCopy(tuple(bufs), done)


class DeferredObserver:
    """Observations whose values are still on their way to the host.

    ``put(copy)`` queues one and returns its ticket; ``drain(upto)`` feeds
    ``observe(*arrays)`` every queued observation up to ticket ``upto``
    (all: None), waiting for their copies, then the later ones whose copies
    have landed, in the order they were put, each once.  ``read()`` is a
    context around each observation's read (the engine's read-site
    counter).  More than ``limit`` queued observations (a caller that never
    drains) feed the oldest at once.  Thread-safe.
    """

    def __init__(self, observe: Callable[..., None],
                 read: Callable[[], ContextManager] = contextlib.nullcontext,
                 limit: int = 8):
        self._observe = observe
        self._read = read
        self.limit = limit
        self._queue: collections.deque = collections.deque()
        self._tickets = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._queue)

    def put(self, copy: HostCopy) -> int:
        with self._lock:
            ticket = self._tickets
            self._tickets += 1
            self._queue.append((ticket, copy))
            oldest = (self._queue[0][0] if len(self._queue) > self.limit
                      else None)
        if oldest is not None:
            self.drain(upto=oldest)
        return ticket

    def drain(self, upto: Optional[int] = None) -> int:
        """Feeds the observations as the class says; returns how many."""
        fed = 0
        with self._lock:  # one drainer at a time keeps the order
            q = self._queue
            while q:
                ticket, copy = q[0]
                due = upto is None or ticket <= upto
                if not due and not copy.ready():
                    break
                with self._read():
                    arrays = copy.wait()
                self._observe(*arrays)
                q.popleft()
                fed += 1
        return fed
