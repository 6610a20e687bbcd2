"""The port's tracer: named spans on the host's monotonic clock.

``with span("oneshot.pivots"): ...`` records the phase's name, its start
and end (``time.monotonic_ns()``), the span it ran inside (its parent, on
the same thread) and a request id, which a root span takes anew and every
span under it shares, so the spans of one ``Retriever`` call carry one id.

The tracer is off by default: :func:`span` then returns one shared no-op
object after a single flag check and records nothing.  :func:`enable`
turns it on.  Records live in preallocated arrays (:data:`CAPACITY`
rows, or what :func:`reset` was given) with names interned as small
ints; a span past the capacity is counted in ``overflow``, not kept.
While the tracer is on,

* every pause of Python's collector is a ``python.gc`` span (a
  ``gc.callbacks`` hook), under whatever span the collecting thread had
  open;
* while ``torch.profiler`` records, each span also opens a profiler range
  of the same name, so an exported trace shows the program's phases
  beside the kernels.  The range is the profiler's own fast record
  function (about 2 us a range against about 14 for
  ``torch.profiler.record_function`` on a CPU core), which its trace
  files as a ``cpu_op`` event.  A collector pause opens none: its
  callback may run inside any allocation, torch's own included.

:func:`records` reads what was recorded (closed spans only);
:func:`reset` empties it; :func:`traced` makes a function's calls spans.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: records kept by default; spans past it are counted, not kept
CAPACITY = 1 << 20
#: the name of a collector pause
GC = "python.gc"

_on = False
_buf: Optional["_Buffer"] = None


class _Noop:
    """What :func:`span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Buffer:
    """The preallocated records and the per-thread stacks of open spans
    (``(slot, request id)`` pairs)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.name = np.zeros(capacity, np.int32)
        self.parent = np.zeros(capacity, np.int64)
        self.rid = np.zeros(capacity, np.int64)
        self.start = np.zeros(capacity, np.int64)
        self.end = np.zeros(capacity, np.int64)
        # next() on a count is one C call, so slots and ids never repeat
        # across threads (and a collector pause may take one mid-span)
        self.slots = itertools.count()
        self.rids = itertools.count()
        self.peeks_over = 0     # slots taken by records() past capacity
        self.names: List[str] = []
        self.ids: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.local = threading.local()
        self.gc_open: Optional[int] = None
        # interned up front: a pause may begin inside intern()'s lock
        self.gc_id = self.intern(GC)

    def intern(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            with self.lock:
                i = self.ids.setdefault(name, len(self.names))
                if i == len(self.names):
                    self.names.append(name)
        return i

    def stack(self) -> List[Tuple[int, int]]:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


class _Span:
    __slots__ = ("_b", "_name", "_slot", "_range")

    def __init__(self, buf: _Buffer, name: str):
        self._b = buf
        self._name = name

    def __enter__(self):
        b = self._b
        stack = b.stack()
        i = next(b.slots)
        if stack:
            parent, rid = stack[-1]
        else:
            parent, rid = -1, next(b.rids)
        stack.append((i, rid))
        self._slot = i
        if torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self._name)
            self._range.__enter__()
        else:
            self._range = None
        if i < b.capacity:
            b.name[i] = b.intern(self._name)
            b.parent[i] = parent
            b.rid[i] = rid
            b.start[i] = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t = time.monotonic_ns()
        b = self._b
        if self._slot < b.capacity:
            b.end[self._slot] = t
        b.stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records ``name`` while the tracer is on
    (the shared no-op object while it is off)."""
    if not _on:
        return NOOP
    return _Span(_buf, name)


def traced(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _on_gc(phase: str, info: dict) -> None:
    b = _buf
    if phase == "start":
        i = next(b.slots)
        b.gc_open = i
        if i < b.capacity:
            stack = getattr(b.local, "stack", None)
            parent, rid = stack[-1] if stack else (-1, -1)
            b.name[i] = b.gc_id
            b.parent[i] = parent
            b.rid[i] = rid
            b.start[i] = time.monotonic_ns()
    elif b.gc_open is not None:
        if b.gc_open < b.capacity:
            b.end[b.gc_open] = time.monotonic_ns()
        b.gc_open = None


def enable() -> None:
    """Turn the tracer on; records kept so far stay."""
    global _on
    if _buf is None:
        reset()
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    _on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays readable."""
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def reset(capacity: int = CAPACITY) -> None:
    """Forget every record and keep at most ``capacity`` from here on;
    the tracer stays on or off as it was."""
    global _buf
    _buf = _Buffer(capacity)


@dataclasses.dataclass
class Records:
    """Closed spans in slot order: ``slot``, ``name`` (str), ``start_ns``,
    ``end_ns``, ``parent`` (the parent's slot; -1 for a root, and for a
    collector pause outside every span) and ``rid`` (request id; -1 for
    such a pause).  ``overflow`` counts spans not kept for want of
    capacity."""

    slot: np.ndarray
    name: np.ndarray
    start_ns: np.ndarray
    end_ns: np.ndarray
    parent: np.ndarray
    rid: np.ndarray
    overflow: int = 0

    def __len__(self) -> int:
        return len(self.slot)

    @property
    def dur_ns(self) -> np.ndarray:
        return self.end_ns - self.start_ns

    def rows(self, slots) -> np.ndarray:
        """Row indices of the records at ``slots`` (-1 where a slot holds
        no closed record)."""
        at = np.searchsorted(self.slot, slots)
        at = np.minimum(at, max(len(self.slot) - 1, 0))
        ok = (len(self.slot) > 0) & (self.slot[at] == slots)
        return np.where(ok, at, -1)

    def self_ns(self, children=None) -> np.ndarray:
        """Each record's duration less the part its direct children cover
        (only children named in ``children``, when given), each child
        clipped to its parent."""
        row = self.rows(self.parent)
        kid = row >= 0
        if children is not None:
            kid &= np.isin(self.name, list(children))
        p = row[kid]
        covered = (np.minimum(self.end_ns[kid], self.end_ns[p])
                   - np.maximum(self.start_ns[kid], self.start_ns[p]))
        out = self.dur_ns.copy()
        np.subtract.at(out, p, np.maximum(covered, 0))
        return out


def records() -> Records:
    """The spans closed since the last :func:`reset` (spans still open
    have no end yet and are left out)."""
    b = _buf
    if b is None:
        z = np.zeros(0, np.int64)
        return Records(z, np.zeros(0, object), z, z, z, z)
    # the slots taken so far; this one stays empty, and is not counted as
    # overflow when it lies past the capacity
    taken = next(b.slots)
    overflow = max(0, taken - b.capacity) - b.peeks_over
    b.peeks_over += taken >= b.capacity
    n = min(taken, b.capacity)
    end = b.end[:n].copy()
    keep = np.flatnonzero(end > 0)
    return Records(
        slot=keep, name=np.asarray(b.names, object)[b.name[keep]],
        start_ns=b.start[keep], end_ns=end[keep], parent=b.parent[keep],
        rid=b.rid[keep], overflow=overflow)
