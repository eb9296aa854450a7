"""decode_tail_roofline: the least time of every decode-tail kernel call in the
stretch profiled with stacks (all the step's frames and object slots,
``reckon.decode_tail``) over the device time of every operation the calls
launched (the skip plane and the kernel's two stages)."""

from benchmark import reckon


def read(run):
    tr = run.stack_trace
    if tr is None:
        return None
    calls = tr.python_ranges(r"ops/kernels/decode_tail\.py\(\d+\): _tail_forward$")
    ops = tr.launched_in(calls)
    if not calls or not ops:
        return None
    t = run.cfg["tracker"]
    h, w = reckon.tracker_hw(run.cfg)
    nbytes, flops = reckon.decode_tail(run.traffic["batch"], t["max_objects"], h // 16, w // 16)
    return 100.0 * len(calls) * reckon.roofline_s(nbytes, flops) / (sum(d["end"] - d["start"] for d in ops) / 1e6)
