"""tracker.readout.device_ms: device time a step of the operations launched inside
the program's ``track::readout`` span, the tracker's memory bank and readout,
one range a window; in the plain profiled stretch, over its ``step`` ranges
(``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "track::readout")
