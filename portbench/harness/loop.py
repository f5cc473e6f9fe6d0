"""The closed loop and what it measures on the host's clock.

One client, no think time: the next texture is sent when the last one's
bytes are in hand.  The window opens when the first texture is sent; no
texture is sent after ``seconds`` have passed, and the window closes when
the last one sent is done, so every texture sent is counted whole and
the window holds all the time they took.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Record:
    """One texture sent in the window."""

    member: int  # index into the content pool
    start: float  # host clock, seconds
    end: float
    ok: bool
    spans: dict
    phases: dict
    data: bytes | None = None
    error: str = ""

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    start: float
    end: float
    records: list

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def done(self) -> list:
        return [r for r in self.records if r.ok]


def run_window(send, order, seconds: float, clock=time.perf_counter, on_done=None) -> Window:
    """Closed loop: ``send(member) -> (data, spans, phases)`` for the
    members of ``order`` in turn (cycling) until ``seconds`` have passed.
    ``on_done(record)``, where given, sees each record as it is made."""
    records = []
    start = clock()
    i = 0
    while i == 0 or clock() - start < seconds:
        member = order[i % len(order)]
        t0 = clock()
        try:
            data, spans, phases = send(member)
            rec = Record(member, t0, clock(), True, spans, phases, data)
        except Exception as exc:  # a failed texture is counted, not fatal
            rec = Record(member, t0, clock(), False, {}, {}, None, f"{type(exc).__name__}: {exc}")
        records.append(rec)
        if on_done is not None:
            on_done(rec)
        i += 1
    return Window(start, records[-1].end, records)


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
