"""Readers-writer lock for the Graph concurrency contract.

Reference parity: the Go library serves concurrent Search under a
``sync.RWMutex`` (reference graph.go:328) and proves it with
1000-goroutine storms (reference graph_test.go:461-527). This is
the CPython equivalent with the re-entrancy shapes this codebase
actually needs:

- re-entrant WRITER (``Graph.build`` deletes replaced keys inside the
  build's write hold),
- re-entrant READER per thread (``search`` -> ``device_graph``), even
  while a writer is waiting — a queued writer must never deadlock a
  thread that already holds a read,
- reads INSIDE the owning thread's write hold (a mutation may consult
  a search),
- read->write upgrade is refused loudly (classic deadlock).

Writer priority, like the reference's RWMutex: a QUEUED writer blocks
new top-level read acquisitions (re-entrant reads still proceed — see
the deadlock shape above), so a continuous read storm cannot starve a
mutation. Measured necessity, not theory: on a contended single-core
host, spinning reader threads starved a batch_add indefinitely under
the no-priority variant.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0            # active read holds (all threads)
        self._writer: int | None = None   # owning thread ident
        self._wdepth = 0
        self._w_waiting = 0          # queued writers (priority gate)
        self._local = threading.local()   # per-thread read depth

    # -- read side -----------------------------------------------------------
    def acquire_read(self) -> None:
        me = threading.get_ident()
        depth = getattr(self._local, "depth", 0)
        with self._cond:
            # nested read (same thread) or read-under-own-write: never
            # wait — waiting here could deadlock against a queued writer
            if depth == 0 and self._writer != me:
                while self._writer is not None or self._w_waiting:
                    self._cond.wait()
            self._local.depth = depth + 1
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            self._local.depth = getattr(self._local, "depth", 1) - 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- write side ----------------------------------------------------------
    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._wdepth += 1
                return
            if getattr(self._local, "depth", 0) > 0:
                raise RuntimeError(
                    "read->write upgrade would deadlock: release the "
                    "read hold before mutating")
            self._w_waiting += 1
            try:
                while self._writer is not None or self._readers > 0:
                    self._cond.wait()
            except BaseException:
                # top-level readers gate on _w_waiting: if this writer
                # bails (e.g. KeyboardInterrupt mid-wait) without ever
                # installing itself, wake them or they miss the drop
                self._w_waiting -= 1
                self._cond.notify_all()
                raise
            self._w_waiting -= 1
            self._writer = me
            self._wdepth = 1

    def release_write(self) -> None:
        with self._cond:
            self._wdepth -= 1
            if self._wdepth == 0:
                self._writer = None
                self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
