"""The readers of the program's spans (``spans.py``, ``metrics/step.*``,
``metrics/tracker.*``) on synthetic traces: device time and launches attributed
to the span they were launched in, each divided by the number of ``step``
ranges; the tracker's sub-layers and a remainder making up ``tracker.device_ms``;
host time in ``track::sync``; an idle gap named by the span open at its start."""

import pytest

from benchmark import run as harness
from benchmark import spans
from benchmark.tracefile import Trace

SUB_LAYERS = ("encode", "readout", "head", "write", "tail", "ids")
SPAN_OF = {"encode": "track::encode", "readout": "track::readout", "head": "track::head",
           "write": "track::write", "tail": "track::tail", "ids": "track::ids"}


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


class _Events:
    """Host ranges on thread 1 and device operations on stream 7, each launched
    at a given host time."""

    def __init__(self):
        self.events, self.corr = [], 0

    def range(self, name, ts, dur):
        self.events.append(_event("user_annotation", name, ts, dur))

    def op(self, launch_ts, start, dur, cat="kernel", name="k"):
        self.corr += 1
        self.events.append(_event("cuda_runtime", "cudaLaunchKernel", launch_ts, 0.5, correlation=self.corr))
        self.events.append(_event(cat, name, start, dur, tid=7, correlation=self.corr))

    def run(self, steps=0):
        tr = Trace(self.events)
        return harness.Run(cfg={}, traffic={}, trace=tr, trace_window=(0, 10_000), trace_steps=steps)


def _two_steps():
    """Two steps of 1000 µs: letterbox, post, and the tracker (the harness's
    ``bench::tracker`` inside ``step::tracker``) with one operation in each
    sub-layer of 10·(k+1) µs in step 0 and 20·(k+1) in step 1, an operation of
    7 µs in the tracker outside every sub-layer, and a wait in ``track::sync``
    of 100 and 300 µs."""
    ev = _Events()
    for s, base in enumerate((0, 2000)):
        scale = s + 1
        ev.range("step", base, 1000)
        ev.range("step::letterbox", base + 10, 40)
        ev.op(base + 20, base + 30, 5 * scale)
        ev.range("step::detector", base + 60, 200)
        ev.op(base + 70, base + 80, 100)
        ev.range("step::post", base + 270, 50)
        ev.op(base + 280, base + 290, 3 * scale, cat="gpu_memset", name="fill")
        ev.range("step::tracker", base + 330, 660)
        ev.range("bench::tracker", base + 335, 640)
        ev.op(base + 336, base + 340, 7)                         # act.any(): in no sub-layer
        ev.range("track::sync", base + 337, 100 * (2 * s + 1))
        at = base + 340 + 100 * (2 * s + 1)
        for k, layer in enumerate(SUB_LAYERS):
            ev.range(SPAN_OF[layer], at, 20)
            ev.op(at + 1, at + 2, 10 * (k + 1) * scale)
            at += 25
        ev.op(base + 980, base + 985, 2, cat="gpu_memcpy", name="copy")  # the ids' checksum, in step::tracker
    ev.op(-60, -50, 50, cat="gpu_memcpy", name="upload")     # an upload before the first step: not the step's
    return ev


def test_each_reader_divides_by_the_steps():
    run = _two_steps().run()
    read = harness.read_metric
    assert read("step.letterbox.device_ms", run) == pytest.approx((5 + 10) / 2 / 1e3)
    assert read("step.post.device_ms", run) == pytest.approx((3 + 6) / 2 / 1e3)
    for k, layer in enumerate(SUB_LAYERS):
        assert read(f"tracker.{layer}.device_ms", run) == pytest.approx(10 * (k + 1) * 3 / 2 / 1e3), layer


def test_sub_layers_and_a_remainder_make_up_the_tracker():
    run = _two_steps().run()
    total = harness.read_metric("tracker.device_ms", run)
    parts = sum(harness.read_metric(f"tracker.{layer}.device_ms", run) for layer in SUB_LAYERS)
    remainder = spans.device_ms(run, "bench::tracker") - parts
    assert total == pytest.approx(spans.device_ms(run, "bench::tracker"))   # both over two ranges
    assert parts <= total and remainder == pytest.approx(7 / 1e3)
    assert parts + remainder == pytest.approx(total)


def test_sync_wait_is_host_time_alone():
    ev = _Events()
    for base in (0, 1000, 2000):
        ev.range("step", base, 900)
        ev.range("track::sync", base + 100, 250)
    run = ev.run()
    assert harness.read_metric("tracker.sync_wait_ms", run) == pytest.approx(250 / 1e3)
    assert run.trace.device == []
    assert harness.read_metric("tracker.readout.device_ms", run) is None


def test_launches_count_kernels_copies_and_fills_inside_step():
    run = _two_steps().run()
    # a step: letterbox, detector, post (a fill), act.any(), six sub-layers, the checksum (a copy)
    assert harness.read_metric("step.launches", run) == pytest.approx(1 + 1 + 1 + 1 + 6 + 1)
    ops = spans.launched(run.trace, "step")
    assert len(ops) == 22 and {d["name"] for d in ops} == {"k", "fill", "copy"}


def test_a_program_without_spans_reads_none():
    ev = _Events()
    ev.range("bench::tracker", 0, 100)
    ev.op(1, 2, 50)
    run = ev.run()
    names = [f"tracker.{layer}.device_ms" for layer in SUB_LAYERS] + [
        "step.letterbox.device_ms", "step.post.device_ms", "tracker.sync_wait_ms", "step.launches"]
    assert all(harness.read_metric(n, run) is None for n in names)
    assert harness.read_metric("tracker.device_ms", run) == pytest.approx(50 / 1e3)
    assert all(harness.read_metric(n, harness.Run(cfg={}, traffic={})) is None for n in names)


def test_breakdown_names_a_gap_in_sync_by_the_span():
    ev = _Events()
    ev.range("step", 0, 1000)
    ev.range("step::tracker", 100, 800)
    ev.range("bench::tracker", 110, 780)
    ev.op(120, 130, 100)                                       # busy 130–230
    ev.range("track::sync", 200, 400)                          # the host waits from 200 to 600
    ev.op(610, 620, 50)                                        # busy 620–670
    gaps = harness.breakdown(ev.run().trace, (130, 670))["idle_gaps"]
    assert gaps == [["track::sync", pytest.approx(390 / 1e6)]]
