"""step.post.device_ms: device time a step of the operations launched inside the
program's ``step::post`` span, the selection of the detections, the best slot's
mask decode and the checksum (``ops/nms.py``, ``ops/masks.py``); in the plain
profiled stretch, over its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "step::post")
