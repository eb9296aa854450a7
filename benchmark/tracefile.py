"""Reading a ``torch.profiler`` trace: device intervals, which host range launched
each device operation, and the union of busy intervals.

The trace is the profiler's Chrome-trace JSON.  Device operations are the
events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each carries
a ``correlation`` id that names the runtime call (``cuda_runtime`` /
``cuda_driver``) that launched it on a host thread.  A host range is a
``user_annotation`` (``record_function``), a ``cpu_op`` or, in a trace taken
with stacks, a ``python_function``; an operation belongs to a range when its launch call lies
inside it on the same thread.  Times are in microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def union_length(intervals: Iterable[Interval], clip: Optional[Interval] = None) -> float:
    """Total length covered by the intervals (overlaps counted once), within ``clip``."""
    spans = sorted((max(a, clip[0]), min(b, clip[1])) if clip else (a, b) for a, b in intervals)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


class Trace:
    def __init__(self, events: List[Dict]):
        self.device: List[Dict] = []
        launches: Dict[int, Tuple[float, int]] = {}
        self.ranges: Dict[str, List[Tuple[float, float, int]]] = {}
        self.py: List[Tuple[float, float, int, str]] = []
        self.host_ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append({"name": e["name"], "start": ts, "end": ts + dur,
                                    "correlation": args.get("correlation")})
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.ranges.setdefault(e["name"], []).append((ts, ts + dur, e.get("tid")))
            elif cat == "python_function":
                self.py.append((ts, ts + dur, e.get("tid"), e["name"]))
            elif cat == "cpu_op":
                self.host_ops.append((ts, ts + dur, e["name"]))
        for d in self.device:
            d["launch"] = launches.get(d["correlation"])

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def launched_in(self, ranges: List[Tuple[float, float, int]]) -> List[Dict]:
        """Device operations whose launch call lies inside one of the host ranges
        (start, end, thread)."""
        by_tid: Dict[int, List[Interval]] = {}
        for a, b, tid in ranges:
            by_tid.setdefault(tid, []).append((a, b))
        for spans in by_tid.values():
            spans.sort()
        out = []
        for d in self.device:
            if d["launch"] is None:
                continue
            ts, tid = d["launch"]
            spans = by_tid.get(tid)
            if not spans:
                continue
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                out.append(d)
        return out

    def python_ranges(self, pattern: str) -> List[Tuple[float, float, int]]:
        """Host ranges of the Python calls whose name ("file.py(line): function")
        matches the regular expression."""
        rx = re.compile(pattern)
        return [(a, b, tid) for a, b, tid, name in self.py if rx.search(name)]

    def busy(self, window: Interval) -> float:
        """Microseconds of the window in which some device operation ran."""
        return union_length(((d["start"], d["end"]) for d in self.device), clip=window)

    def gaps(self, window: Interval) -> List[Interval]:
        """The idle stretches of the window, between device operations."""
        spans = sorted((max(d["start"], window[0]), min(d["end"], window[1])) for d in self.device
                       if d["end"] > window[0] and d["start"] < window[1])
        out, at = [], window[0]
        for a, b in spans:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if window[1] > at:
            out.append((at, window[1]))
        return out
