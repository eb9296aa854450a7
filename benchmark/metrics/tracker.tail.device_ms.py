"""tracker.tail.device_ms: device time a step of the operations launched inside the
program's ``track::tail`` span, the tracker's skip projections and decode tail;
in the plain profiled stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::tail")
