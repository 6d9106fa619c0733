"""Spans of a run's phases, on the clock the profiler's trace shares.

Tracing is off until a caller turns it on with :func:`enable` and off again
with :func:`disable`.  Off, :func:`span` returns one shared no-op context
manager: no record, no clock read, no profiler call.  On, every span appends
one :class:`Span` to an in-memory list, stamped with ``time.time_ns()`` at
its start and its end; :func:`take` hands the list out and empties it.

``torch.profiler`` stamps its host events on the unix clock that
``time.time_ns()`` reads and brings the card's records onto it, so a span
and the card's kernels share one clock without a host op being recorded:
the card's idle time can be put down to the span open when it happened.
``enable(annotate=True)`` also opens a ``torch.profiler.record_function`` of
the span's name in each span, so a profiler trace that records host ops
shows the phases (``run_simulation(profile_dir=)``).

The controller opens the spans at its layer boundaries, never inside a loop
over paths, substeps or dates.  A span opened while no other is open is a
root, and starts a new run: ``Span.run`` counts the roots since the module
was loaded.  Spans change no value.  Attributes are small ints or strings
(``phase``, ``family``, ``products``, ``paths``, ``tangents``; an
``exercise`` span, around one loop of an exercise scan over its dates,
carries ``kind``, ``products``, ``steps`` and ``phase`` "fit" or "value").
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Union

Attr = Union[int, str]


class Span(NamedTuple):
    """One closed span: ``parent`` is the index of the enclosing span in
    the same :func:`take` list (-1 for a root); times are ``time.time_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    run: int
    attrs: Dict[str, Attr]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_records: Optional[List[list]] = None  # [name, start, end, parent, run, attrs]; None when off
_open: List[int] = []  # indices of the open spans, innermost last
_annotate = False
_runs = 0


class _Live:
    __slots__ = ("name", "attrs", "row", "scope")

    def __init__(self, name: str, attrs: Dict[str, Attr]):
        self.name, self.attrs, self.scope = name, attrs, None

    def __enter__(self):
        global _runs
        if not _open:
            _runs += 1
        self.row = [self.name, 0, 0, _open[-1] if _open else -1, _runs, self.attrs]
        _open.append(len(_records))
        _records.append(self.row)
        if _annotate:
            from torch.profiler import record_function

            self.scope = record_function(self.name)
            self.scope.__enter__()
        self.row[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.row[2] = time.time_ns()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, **attrs: Attr):
    """A context manager that records the phase ``name`` while tracing is
    on; the shared no-op while it is off."""
    if _records is None:
        return _NOOP
    return _Live(name, attrs)


def enabled() -> bool:
    return _records is not None


def annotating() -> bool:
    return _annotate


def enable(annotate: bool = False) -> None:
    """Turn tracing on (records kept so far stay); ``annotate`` opens a
    ``record_function`` of each span's name as well."""
    global _records, _annotate
    if _records is None:
        _records = []
    _annotate = bool(annotate)


def disable() -> None:
    """Turn tracing off and drop the records not yet taken."""
    global _records, _annotate
    if _open:
        raise RuntimeError("tracing.disable() inside an open span")
    _records, _annotate = None, False


def take() -> List[Span]:
    """The spans recorded since the last call, oldest first; empties the
    list.  Call it between runs, with no span open."""
    global _records
    if _open:
        raise RuntimeError("tracing.take() inside an open span")
    if _records is None:
        return []
    rows, _records = _records, []
    return [Span(r[0], r[1], r[2], r[3], r[4], r[5]) for r in rows]
