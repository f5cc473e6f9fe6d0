"""What the traced run takes from ``torch.profiler``, reduced in memory.

The window runs under the profiler (CPU and CUDA activities) inside a
``portbench.window`` range; nothing is written to disk.  From the raw
events this keeps: the device's busy time (the union of every kernel,
copy and set on the card, clipped to the window), each device
operation's total time, and the window's idle time by what the host was
doing, named by the benchmark's innermost ``portbench.*`` range and the
outermost host operation running then.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "portbench.window"
ANNOTATION = "portbench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict  # device operation name -> seconds in the window
    idle_s: dict  # host activity -> idle seconds of the device
    device_events: int

    def top_device_ops(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:n]]

    def device_time(self, pattern: str) -> float:
        """Seconds of the device operations whose name holds pattern."""
        return sum(v for k, v in self.device_s.items() if pattern in k)


def reduce(results) -> Trace:
    """Reduce a stopped profiler's raw results (``prof.profiler.kineto_results``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, annos, ops = [], [], []
    for e in results.events():
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if name.startswith(ANNOTATION):
            # The profiler mirrors each range on the device's timeline too.
            if e.device_type() != cuda:
                annos.append((s, t, name))
        elif e.device_type() == cuda:
            dev.append((s, t, name))
        elif t > s:
            ops.append((s, t, name))
    win = [a for a in annos if a[2] == WINDOW]
    if win:
        w0, w1 = win[0][0], win[0][1]
    else:
        w0 = min(a[0] for a in annos + dev)
        w1 = max(a[1] for a in annos + dev)

    device_s = collections.defaultdict(float)
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            device_s[name] += (t - s) * 1e-9
            spans.append((s, t))
    spans.sort()
    busy = []
    for s, t in spans:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    busy_ns = sum(t - s for s, t in busy)

    gaps = []
    prev = w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))

    # Top-level host operations: those no other operation contains.
    ops.sort(key=lambda o: (o[0], -o[1]))
    top = []
    for o in ops:
        if not top or o[0] >= top[-1][1]:
            top.append(o)
    top_starts = [o[0] for o in top]
    inner = sorted((a for a in annos if a[2] != WINDOW), key=lambda a: a[0])
    inner_starts = [a[0] for a in inner]

    def covering(starts, items, at):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and items[i][1] > at:
            return items[i][2]
        return None

    idle_s = collections.defaultdict(float)
    for s, t in gaps:
        mid = (s + t) // 2
        where = covering(inner_starts, inner, mid)
        where = where[len(ANNOTATION):] if where else "loop"
        what = covering(top_starts, top, mid) or "host"
        idle_s[f"{where}:{what}"] += (t - s) * 1e-9
    return Trace((w1 - w0) * 1e-9, busy_ns * 1e-9, dict(device_s), dict(idle_s), len(dev))
