"""Reading the program's own spans (``yolo_puncture_tpu_torch/utils/profiling.py
span``) in the plain profiled stretch: each reader of ``metrics/`` that reads
one is a line over these.

Every number is a step's share: a sum over the stretch divided by the number of
the program's root ``step`` ranges in it, as ``tracker.device_ms`` divides by its
own range's count.  Without a trace, or where the stretch holds no ``step`` or
no range of the name (a program without that span), a reader gets None.
"""

from __future__ import annotations

from typing import Optional

from benchmark.tracefile import Trace

STEP = "step"


def _steps(trace: Optional[Trace]) -> int:
    return len(trace.ranges.get(STEP, [])) if trace is not None else 0


def launched(trace: Optional[Trace], name: str) -> Optional[list]:
    """The device operations launched inside the ranges named ``name``, or None
    where there are none (a CPU run has no device operations)."""
    if not _steps(trace) or not trace.ranges.get(name):
        return None
    return trace.launched_in(trace.ranges[name]) or None


def device_ms(run, name: str) -> Optional[float]:
    """Device milliseconds a step of the operations launched inside ``name``."""
    ops = launched(run.trace, name)
    if ops is None:
        return None
    return sum(d["end"] - d["start"] for d in ops) / _steps(run.trace) / 1e3


def host_ms(run, name: str) -> Optional[float]:
    """Host milliseconds a step inside the ranges named ``name``."""
    if not _steps(run.trace) or not run.trace.ranges.get(name):
        return None
    return sum(b - a for a, b, _ in run.trace.ranges[name]) / _steps(run.trace) / 1e3


def launches(run, name: str = STEP) -> Optional[float]:
    """Device operations (kernels, copies, fills) launched inside ``name``, a step."""
    ops = launched(run.trace, name)
    if ops is None:
        return None
    return len(ops) / _steps(run.trace)
