"""Spans of the port: where one texture's time goes, layer by layer.

``span(name)`` times a block on ``time.perf_counter_ns()`` and, when it
ends, keeps a `Span` (name, start, end, its own id, its parent's id, its
texture's id) in the `Record` of the texture being worked on.  Each
public `Texture` call opens its root span with the texture's own record
(``Texture.spans``), and a context variable carries that record, and the
innermost open span, for the length of the call: spans of textures
converted in turn or on other threads never meet.  A span opened outside
any record keeps nothing.  A record holds its texture's newest
`MAX_SPANS` spans, in memory only.

A root span also sums the seconds of every span below it under the last
segment of the span's name (`phases`): ``pipeline.upload`` adds to
``upload``.  That is ``Texture.last_convert_stats["phases"]``.

`summary` turns spans into seconds by name, totals and self times.

Inside `ranges()`, and only while a ``torch.profiler`` runs, each span
also opens a ``record_function(f"cuttlefish.{name}")`` range, so that its
host interval sits on the device trace's clock.  The profiler mirrors a
range on the device's timeline from its first device operation to its
last, so a reader of the device's busy time has to leave those mirrors
out; ranges are opened only where the reader asks for them.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 256

_span_ids = itertools.count(1)
_texture_ids = itertools.count(1)


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int | None  # id of the span it ran inside, None for a root
    texture: int  # id of the record (texture) it belongs to


class Record(collections.deque):
    """One texture's spans, its newest `MAX_SPANS`, each kept as it ends
    (so a span's children come before it)."""

    def __init__(self, spans=(), maxlen=MAX_SPANS):  # deque's arguments, for copies
        super().__init__(spans, maxlen)
        self.texture = next(_texture_ids)


class _Scope(NamedTuple):
    record: Record | None
    span: int | None  # id of the innermost open span
    phases: dict | None  # the root span's sums by the last segment of a name


_scope = contextvars.ContextVar("cuttlefish_span_scope", default=_Scope(None, None, None))
_ranges = contextvars.ContextVar("cuttlefish_span_ranges", default=False)


class span:
    """Context manager: a span named ``name``.  With ``record`` it is a root
    span of that record (a public `Texture` call); without, it belongs to
    the record of the enclosing root span, if any."""

    __slots__ = ("name", "_record", "_id", "_parent", "_sink", "_token", "_range", "_t0")

    def __init__(self, name: str, record: Record | None = None):
        self.name = name
        self._record = record

    def __enter__(self):
        self._range = None
        if _ranges.get() and _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function("cuttlefish." + self.name)
            self._range.__enter__()
        outer = _scope.get()
        root = self._record is not None
        if not root:
            self._record = outer.record
        if self._record is None:
            self._token = None
            return self
        self._id = next(_span_ids)
        self._parent = outer.span if outer.record is self._record else None
        self._sink = None if root else outer.phases
        below = {} if root else outer.phases
        self._token = _scope.set(_Scope(self._record, self._id, below))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            t1 = time.perf_counter_ns()
            _scope.reset(self._token)
            rec = self._record
            rec.append(Span(self.name, self._t0, t1, self._id, self._parent, rec.texture))
            if self._sink is not None:
                key = self.name.rpartition(".")[2]
                self._sink[key] = self._sink.get(key, 0.0) + (t1 - self._t0) * 1e-9
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def phases() -> dict[str, float]:
    """Seconds of the spans below the innermost open root span so far, by
    the last segment of their names; empty outside any record."""
    return dict(_scope.get().phases or {})


@contextlib.contextmanager
def ranges():
    """Spans opened inside also open ``record_function`` ranges while a
    ``torch.profiler`` runs (in this context: the thread, or the task)."""
    token = _ranges.set(True)
    try:
        yield
    finally:
        _ranges.reset(token)


def summary(spans) -> dict[str, float]:
    """Seconds by span name over ``spans``: ``{name: total}`` and
    ``{name + ":self": self}``, where a span's self time is its duration
    less the part of it that its children (among ``spans``) cover."""
    spans = list(spans)
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out: dict[str, float] = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        own = s.end_ns - s.start_ns
        out[s.name] = out.get(s.name, 0.0) + own * 1e-9
        key = s.name + ":self"
        out[key] = out.get(key, 0.0) + (own - covered) * 1e-9
    return out
