"""tracker.ids.device_ms: device time a step of the operations launched inside the
program's ``track::ids`` span, the tracker's id maps (upsample, aggregate,
argmax); in the plain profiled stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::ids")
