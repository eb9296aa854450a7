"""step_latency_ms_p90: the 90th percentile, over every step of the window, of
the host time from handing the batch to the step until its outputs are in host
memory (``statistics.quantiles(n=10)``, the exclusive method)."""

import statistics


def read(run):
    lat = [(s["done"] - s["hand"]) * 1e3 for s in run.steps]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10)[8]
