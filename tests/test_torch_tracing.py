"""The port's spans (``utils/profiling.py span``): the fused step of
``bench.make_fused_step`` under ``torch.profiler`` records each span where the
work happens, nested in its root ``step``; without a profiler it enters no
``record_function``; the profiler changes no output; ``StageTimer``'s stages
are spans.  The toy size of ``tests/test_torch_bench.py`` (B 8, windows of 4),
read with the benchmark's own trace parser."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.tracefile import Trace
from tests.torch_parity import torch_single_thread  # noqa: F401
from yolo_puncture_tpu_torch import bench
from yolo_puncture_tpu_torch.utils import profiling

FRAME_HW, MIN_SIDE, IMGSZ, B, WINDOW = (96, 160), 64, 64, 8, 4

STEP_SPANS = ("step", "step::letterbox", "step::detector", "step::post", "step::tracker")
# spans a step records: one each, and one a window for the ring's readout, head and write;
# the tail is two ranges (the skips' projections, the decode tail)
COUNTS = {**{name: 1 for name in STEP_SPANS}, "track::encode": 1, "track::sync": 1,
          "track::readout": B // WINDOW, "track::head": B // WINDOW, "track::write": B // WINDOW,
          "track::tail": 2, "track::ids": 1}


def _frames(seed=0):
    """BGR uint8 frames of a bright bar moving right over noise."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 70, (B, *FRAME_HW, 3)).astype(np.uint8)
    for i in range(B):
        f[i, 30:44, 20 + 3 * i:80 + 3 * i] = 225
    return torch.from_numpy(f)


def _raise(name):
    raise AssertionError(f"record_function({name!r}) entered with no profiler running")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One fused step from the same memory twice: with no profiler (and
    ``record_function`` made to raise), then under the profiler (CPU activity).
    Returns (plain (outputs, memory), profiled (outputs, memory), its Trace)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "FRAME_HW", FRAME_HW)
        mp.setattr(bench, "MIN_SIDE", MIN_SIDE)
        model, (mem0, track_fn) = bench.bench_models(IMGSZ, True, "cpu")
    step = bench.make_fused_step(model, track_fn, IMGSZ)
    frames, chk = _frames(), torch.zeros(())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "record_function", _raise)
        plain = step(mem0, frames, 0.02, chk)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiled = step(mem0, frames, 0.02, chk)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return plain, profiled, Trace.load(path)


def test_fused_step_records_each_span_nested_in_step(steps):
    _, _, tr = steps
    assert {name: len(tr.ranges.get(name, [])) for name in COUNTS} == COUNTS
    (s0, s1, tid), = tr.ranges["step"]
    (t0, t1, _), = tr.ranges["step::tracker"]
    for name in COUNTS:
        for a, b, t in tr.ranges[name]:
            assert t == tid and s0 <= a <= b <= s1, name
            if name.startswith("track::"):
                assert t0 <= a <= b <= t1, name
    # the step's parts follow one another; the windows' readout, head and write too
    order = [tr.ranges[n][0] for n in STEP_SPANS[1:]]
    assert all(x[1] <= y[0] for x, y in zip(order, order[1:]))
    layers = sorted((a, b, n) for n in ("track::readout", "track::head", "track::write") for a, b, _ in tr.ranges[n])
    assert [n for _, _, n in layers] == ["track::readout", "track::head", "track::write"] * (B // WINDOW)
    assert all(x[1] <= y[0] for x, y in zip(layers, layers[1:]))


def test_profiler_changes_no_output(steps):
    """The plain step (which entered no ``record_function``: the fixture made it
    raise) and the profiled one give the same outputs and memory."""
    (out_a, mem_a), (out_b, mem_b), _ = steps
    assert out_a.keys() == out_b.keys()
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    for f in dataclasses.fields(mem_a):
        k, v, w = f.name, getattr(mem_a, f.name), getattr(mem_b, f.name)
        assert torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w, k


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _raise)
    timer = profiling.StageTimer()
    with profiling.span("step"), timer.stage("detect"):
        pass
    assert timer.counts["detect"] == 1


def test_stage_timer_stages_are_spans(tmp_path):
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with timer.stage("device_submit"):
                torch.ones(4).add_(1)
        with timer.stage("host_geometry"):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    tr = Trace.load(tmp_path / "trace.json")
    assert len(tr.ranges["device_submit"]) == 2 and len(tr.ranges["host_geometry"]) == 1
    summary = timer.summary()
    assert summary["device_submit"]["count"] == 2 and summary["host_geometry"]["count"] == 1
