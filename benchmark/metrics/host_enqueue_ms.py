"""host_enqueue_ms: the median over the window's steps of the host time from
handing a batch in (its upload enqueued) until the program's step call returns."""

import statistics


def read(run):
    if not run.steps:
        return None
    return statistics.median((s["ret"] - s["hand"]) * 1e3 for s in run.steps)
