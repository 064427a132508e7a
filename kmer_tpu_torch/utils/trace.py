"""The port's spans and counters: one in-process tracer.

A span is a named interval of one thread: start and end on
`time.perf_counter()`, the thread, its own id, the id of the span that
caused it, and counts taken at the same boundary (`attrs`).  Spans are
kept in memory, in one store of at most CAPACITY spans (past it the
oldest go, and `dropped()` counts them); `spans()` reads them.  The
tracer never writes them out.

It records only while it is on:

  * while a torch.profiler session of this process is active (the
    benchmark's traced stretch, or KMER_TPU_PROFILE=<dir>); each span
    then also enters torch.profiler.record_function("kmer.<name>"), so
    it lands in the profiler's Chrome trace beside the kernels, on the
    profiler's own clock;
  * after `enable(True)` (tests, and timing what tracing costs), with or
    without a profiler.

Off, `span()` costs one check and returns NULL, which records nothing.
A span opened without `parent` decides for itself and takes the
innermost open span of its own thread as parent.  Work in another thread
passes its parent explicitly (a count loop hands its span to the reader
thread) and follows that span's decision: NULL there records nothing.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16
PREFIX = "kmer."

_forced = False
_ids = itertools.count(1)
_store: deque = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0
_local = threading.local()


class Timer:
    """The interval of a `with` block (`seconds`), recorded nowhere:
    what `timed()` gives while the tracer is off.  Falsy."""

    __slots__ = ("t0", "t1")
    id = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        return False

    def __bool__(self) -> bool:
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> None:
        pass


class _Null(Timer):
    """The span that records nothing and takes no time."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Span(Timer):
    """A recorded span; truthy.  `set()` adds counts before it ends."""

    __slots__ = ("name", "id", "parent", "thread", "attrs", "_rf")

    def __init__(self, name: str, parent: Optional[int], attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.attrs = attrs
        self.t0 = self.t1 = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.thread = threading.get_ident()
        _stack().append(self)
        self._rf = _profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        global _dropped
        with _lock:
            if len(_store) == CAPACITY:
                _dropped += 1
            _store.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.t1 - self.t0:.6f} s, {self.attrs})")


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def span(name: str, parent=None, **attrs):
    """A span `name` as a context manager; NULL while the tracer is off,
    or when `parent` (a span, for work in another thread) is NULL."""
    if parent is None:
        if not (_forced or _profiler._is_profiler_enabled):
            return NULL
        s = getattr(_local, "stack", None)
        return Span(name, s[-1].id if s else None, attrs)
    return Span(name, parent.id, attrs) if parent else NULL


def timed(name: str, parent=None, **attrs):
    """`span()` for an interval the program times anyway: off, a Timer,
    so `seconds` is there either way and the time is taken once."""
    sp = span(name, parent, **attrs)
    return sp if sp else Timer()


def enable(flag: bool = True) -> None:
    """Record with or without a profiler (True), or only under one."""
    global _forced
    _forced = bool(flag)


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Spans dropped from the store since the last `clear()`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0

