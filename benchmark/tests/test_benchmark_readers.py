"""The readers' arithmetic: the tail over every step, the idle share over the
union of device intervals, launches attributed to the host range they came from."""

import statistics

import pytest

from benchmark import run as harness
from benchmark.tracefile import Trace, union_length


def _read(name, run):
    return harness.read_metric(name, run)


def test_p90_is_taken_over_every_step():
    lat = [100.0] * 90 + [200.0 + i for i in range(10)]
    steps = [{"hand": 0.0, "ret": 0.001, "done": v / 1e3, "frames": 8} for v in lat]
    run = harness.Run(cfg={}, traffic={}, steps=steps, window_s=2.0)
    assert _read("step_latency_ms_p90", run) == pytest.approx(statistics.quantiles(lat, n=10)[8])
    assert _read("step_latency_ms_p90", run) > 100.0          # the slow tenth moves it
    assert _read("frames_per_s", run) == pytest.approx(8 * 100 / 2.0)


def test_union_counts_overlap_once_and_clips():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert union_length(spans) == 15 + 10 + 10
    assert union_length(spans, clip=(8, 45)) == 7 + 10 + 5


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_idle_share_over_two_streams_and_attribution():
    events = [
        _event("user_annotation", "bench::wait", 0, 10),
        _event("user_annotation", "bench::detector", 10, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _event("kernel", "a", 20, 30, tid=7, correlation=1),     # stream 7
        _event("kernel", "b", 40, 20, tid=8, correlation=2),     # stream 8, overlapping a
        _event("user_annotation", "bench::wait", 90, 10),
    ]
    tr = Trace(events)
    run = harness.Run(cfg={}, traffic={}, trace=tr, trace_window=(10, 100), trace_steps=1, plain_step_s=80e-6)
    assert tr.busy((10, 100)) == 40                            # 20–60, once
    assert _read("device_idle_pct", run) == pytest.approx(100 * (1 - 40 / 80))   # against the unprofiled step
    assert [d["name"] for d in tr.launched_in(tr.ranges["bench::detector"])] == ["a"]
    assert _read("detector.device_ms", run) == pytest.approx(30 / 1e3)
    assert [g for g in tr.gaps((10, 100))] == [(10, 20), (60, 100)]


def test_unprofiled_pace_leaves_out_profiled_steps():
    """A step counts towards the unprofiled pace only where no profiler ran from
    its hand-in to its outputs; step_mfu is read against that pace."""
    done = [1.0, 2.0, 3.0, 5.0, 7.0, 8.0, 9.0]                  # steps 3 and 4 profiled: 2 s apart
    steps = [{"hand": d - 1.5, "done": d, "frames": 8} for d in done]
    pace = harness._plain_step_s(steps, [[3.6, 6.9]])
    assert pace == pytest.approx(1.0)
    run = harness.Run(cfg={}, traffic={}, plain_step_s=pace, step_flops=int(9.89e12))
    assert _read("step_mfu", run) == pytest.approx(1.0)         # 9.89 TFLOP a second: 1 % of 989
