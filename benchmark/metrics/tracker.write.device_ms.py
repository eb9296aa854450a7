"""tracker.write.device_ms: device time a step of the operations launched inside
the program's ``track::write`` span, the tracker's ring write (aggregate at
stride 16, value encoder, write), one range a window; in the plain profiled
stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::write")
