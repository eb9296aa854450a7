"""tracker.sync_wait_ms: host time a step inside the program's ``track::sync``
spans, the tracker's reads of a device value (``bool(act.any())`` once a step):
how long the host sat blocked on the card, in the plain profiled stretch, over
its ``step`` ranges (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, "track::sync")
