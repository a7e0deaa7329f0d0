"""The traced window, read from ``torch.profiler``'s Chrome trace.

The benchmark wraps its whole window in the range ``pb.window`` and each
call into the port in ``pb.<name>`` (``torch.profiler.record_function``).
The profiler marks each range's span on the device as well
(``gpu_user_annotation``); a device operation (kernel, copy or fill)
belongs to the innermost such range that holds its midpoint.  Busy time is
the union of the device operations inside the window; an idle gap is
labelled by the range the host was in when it began.
"""

from __future__ import annotations

import json
from typing import NamedTuple

WINDOW = "pb.window"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "between ranges"


class Trace(NamedTuple):
    window_s: float  # the window's length on the trace's clock
    busy_s: float  # time in which a device operation ran, inside the window
    range_s: dict  # range name -> device seconds of the operations in it
    ops_s: dict  # device operation name -> seconds
    idle_s: dict  # range the host was in (or OUTSIDE) -> idle seconds


def _spans(events: list, cat: str) -> list[tuple[float, float, str]]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") == cat)


class _Innermost:
    """The shortest span holding t, for t that never decrease."""

    def __init__(self, spans: list):
        self.spans, self.next, self.open = spans, 0, []

    def at(self, t: float) -> str | None:
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.open.append(self.spans[self.next])
            self.next += 1
        self.open = [s for s in self.open if s[1] >= t]
        return min(self.open, key=lambda s: s[1] - s[0])[2] if self.open else None


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = _spans(events, "user_annotation")
    windows = [s for s in host if s[2] == WINDOW]
    if not windows:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    w0, w1, _ = windows[0]
    ops = sorted(s for cat in DEVICE_OPS for s in _spans(events, cat) if s[1] > w0 and s[0] < w1)
    ops_s: dict = {}
    for a, b, name in ops:
        ops_s[name] = ops_s.get(name, 0.0) + (b - a) / 1e6
    marks = _Innermost([s for s in _spans(events, "gpu_user_annotation") if s[2] != WINDOW])
    range_s: dict = {}
    for mid, dur in sorted(((a + b) / 2, b - a) for a, b, _ in ops):
        where = marks.at(mid)
        if where is not None:
            range_s[where] = range_s.get(where, 0.0) + dur / 1e6
    in_range = _Innermost([s for s in host if s[2] != WINDOW])
    busy, idle, end = 0.0, {}, w0
    for a, b, _ in ops + [(w1, w1, "")]:
        a, b = max(a, w0), min(b, w1)
        if a > end:
            label = in_range.at(end) or OUTSIDE
            idle[label] = idle.get(label, 0.0) + (a - end) / 1e6
        if b > end:
            busy += (b - max(a, end)) / 1e6
            end = b
    return Trace((w1 - w0) / 1e6, busy, range_s, ops_s, idle)
