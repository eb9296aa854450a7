"""memory_readout_roofline: the least time of every ``memory_readout`` kernel
call in the stretch profiled with stacks (a window's queries against a full
ring; the long-term bank empty, ``reckon.memory_readout``) over the device time
of every operation the calls launched (validity pack, readout, combine)."""

from benchmark import reckon


def read(run):
    tr = run.stack_trace
    if tr is None:
        return None
    calls = tr.python_ranges(r"ops/kernels/memory_readout\.py\(\d+\): _launch$")
    ops = tr.launched_in(calls)
    if not calls or not ops:
        return None
    t = run.cfg["tracker"]
    h, w = reckon.tracker_hw(run.cfg)
    hw = (h // 16) * (w // 16)
    ring = t["mem_frames"] * hw
    nbytes, flops = reckon.memory_readout(t["window"] * hw, ring + 8, ring, t["max_objects"], t["key_dim"],
                                          t["value_dim"])
    return 100.0 * len(calls) * reckon.roofline_s(nbytes, flops) / (sum(d["end"] - d["start"] for d in ops) / 1e6)
