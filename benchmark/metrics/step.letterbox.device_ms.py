"""step.letterbox.device_ms: device time a step of the operations launched inside
the program's ``step::letterbox`` span, the letterbox (``ops/letterbox.py``); in
the plain profiled stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "step::letterbox")
