"""frames_per_s: frames whose outputs reached the host in the window, over the
window's seconds (from its first hand-in to its last output on the host)."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return sum(s["frames"] for s in run.steps) / run.window_s
