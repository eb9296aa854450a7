"""tracker.encode.device_ms: device time a step of the operations launched inside
the program's ``track::encode`` span, the tracker's resize and key encoder; in
the plain profiled stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::encode")
