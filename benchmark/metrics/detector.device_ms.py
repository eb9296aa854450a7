"""detector.device_ms: device time a step of the operations launched inside the
detector's forward (the ``bench::detector`` range), in the plain profiled stretch."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.ranges.get("bench::detector", [])
    ops = run.trace.launched_in(spans)
    if not spans or not ops:
        return None
    return sum(d["end"] - d["start"] for d in ops) / len(spans) / 1e3
