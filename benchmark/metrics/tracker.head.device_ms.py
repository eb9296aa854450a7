"""tracker.head.device_ms: device time a step of the operations launched inside the
program's ``track::head`` span, the tracker's decoder head and sensory GRU, one
range a window; in the plain profiled stretch, over its ``step`` ranges
(``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::head")
