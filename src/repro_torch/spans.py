"""The program's spans: named intervals at the layer boundaries of the
mapping engine and its solvers, on the host's monotonic clock.

Off by default.  The caller turns the recorder on with :func:`enable`;
while it is off, :func:`span` returns one shared no-op object after a
single module-global check, allocating nothing and reading no clock.
While it is on, each span records its id, the enclosing span of the
same thread (its parent), its name, its thread, its start and end from
``time.monotonic_ns()`` (the clock of ``MapFuture.resolved_at``) and
its attributes.  Records stay in memory until :func:`drain` takes them.

    spans.enable()
    with spans.span("engine.group", bucket=128) as s:
        ...
        s.set(warm=3)
    records = spans.drain()
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

_on = False
_records: List["Span"] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """What :func:`span` returns while the recorder is off: a context
    manager that records nothing, and is false."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        return None


OFF = _Off()


class Span:
    """One recorded interval; ``parent`` is the id of the span that
    enclosed it on the same thread, None at the top."""
    __slots__ = ("id", "parent", "name", "thread", "start_ns", "end_ns",
                 "attrs")

    def __init__(self, name: str, attrs: Dict) -> None:
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.name = name
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.monotonic_ns()
        _local.stack.pop()
        with _lock:
            _records.append(self)


def span(name: str, **attrs):
    """A context manager timing ``name``: a :class:`Span` while the
    recorder is on, the shared :data:`OFF` while it is off."""
    if not _on:
        return OFF
    return Span(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """Every span ended since the last drain, in the order they ended;
    the store is left empty."""
    global _records
    with _lock:
        out, _records = _records, []
    return out
