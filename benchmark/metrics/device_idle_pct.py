"""device_idle_pct: the share of a step's time in which no kernel, copy or fill
runs on the card.  The device's busy time a step (the union of the device
intervals over all streams, from the plain profiled stretch, over its steps)
is set against the time a step takes where no profiler runs (``plain_step_s``):
the profiler's host work slows a step whose pace the host sets, and would read
as idle time that an unprofiled run does not have."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace_steps < 1 or run.plain_step_s <= 0:
        return None
    a, b = run.trace_window
    busy_per_step_s = run.trace.busy((a, b)) / 1e6 / run.trace_steps
    return 100.0 * (1.0 - busy_per_step_s / run.plain_step_s)
