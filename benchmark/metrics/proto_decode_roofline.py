"""proto_decode_roofline: the least time of every ``proto_decode`` call in the
stretch profiled with stacks (its launch shape: the batch's best slot decoded
soft at prototype resolution, ``reckon.proto_decode``) over the device time of
every operation those calls launched."""

from benchmark import reckon


def read(run):
    tr = run.stack_trace
    if tr is None:
        return None
    calls = tr.python_ranges(r"ops/kernels/proto_decode\.py\(\d+\): proto_decode$")
    ops = tr.launched_in(calls)
    if not calls or not ops:
        return None
    side = run.cfg["detector"]["imgsz"] // 4
    nbytes, flops = reckon.proto_decode(run.traffic["batch"], 1, side, side, run.cfg["detector"]["nm"])
    return 100.0 * len(calls) * reckon.roofline_s(nbytes, flops) / (sum(d["end"] - d["start"] for d in ops) / 1e6)
