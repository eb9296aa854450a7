"""Spans on the profiler's clock, per-stage host-clock timing of the pipeline,
and a device trace scope.

Counterpart of ``StageTimer`` and ``device_trace`` in
``yolo_puncture_tpu/utils/profiling.py``; ``span`` is the port's own.

``span(name)`` opens a ``record_function`` range only while a profiler runs on
this thread, so the range lands in the same ``torch.profiler`` trace as the
kernels it launches, on the trace's own clock; with no profiler running it costs
one flag test and makes no dispatcher call.  Spans nest: a span's parent is the
span open around it on the same thread.  The spans an operator finds in a trace
of the fused step (``bench.make_fused_step``, ``python -m
yolo_puncture_tpu_torch.bench --trace DIR``):

  * ``step`` (the root: one a step), and inside it ``step::letterbox``,
    ``step::detector`` (the forward), ``step::post`` (``select_detections``,
    ``decode_masks``, the checksum) and ``step::tracker`` (the tracker's step
    and the id maps' checksum);
  * inside the tracker: ``track::encode`` (resize and key encoder, or the
    pyramid encoder), ``track::readout`` (the memory bank and the readout, one a
    window), ``track::head`` (decoder head and sensory GRU, one a window),
    ``track::write`` (aggregate at stride 16, consolidation, value encoder, ring
    write, one a window), ``track::tail`` (skip projections and the decode tail),
    ``track::ids`` (upsample, aggregate, argmax) and ``track::sync``, around each
    read of a device value by the host: the host waits there for the card.

``StageTimer``'s stages are spans too.  Its clock does not wait for the device:
a stage that only launches work on the card measures the launch, and the wait
shows in the stage that fetches.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs on this
    thread (read when the span opens); nothing otherwise."""
    if not _profiler_enabled():
        yield
        return
    with record_function(name):
        yield


class StageTimer:
    """Accumulates wall-clock per named pipeline stage; each stage is also a
    ``span`` of its name.

    with timer.stage("detect"): ...
    timer.summary() → {stage: {"total_s", "count", "mean_ms"}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """``torch.profiler`` scope over the host and, where there is a card, its
    kernels; no-op when ``trace_dir`` is None.  Writes ``trace.json`` (a Chrome
    trace, with the spans above as ``user_annotation`` ranges) and
    ``kernels.txt`` (time by kernel, ``key_averages``) into ``trace_dir``.
    Yields the profiler, or None."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    sort = "cuda_time_total" if ProfilerActivity.CUDA in activities else "cpu_time_total"
    with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
