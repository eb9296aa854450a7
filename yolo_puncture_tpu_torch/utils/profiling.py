"""Per-stage host-clock timing of the pipeline, and a device trace scope.

Counterpart of ``StageTimer`` and ``device_trace`` in
``yolo_puncture_tpu/utils/profiling.py``.  The clock does not wait for the
device: a stage that only launches work on the card measures the launch, and the
wait shows in the stage that fetches.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall-clock per named pipeline stage.

    with timer.stage("detect"): ...
    timer.summary() → {stage: {"total_s", "count", "mean_ms"}}
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
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

    def report(self) -> str:
        lines = ["stage timing:"]
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"  {k:<24} {v['total_s']:8.3f}s  ×{v['count']:<5} "
                f"({v['mean_ms']:.2f} ms avg)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """``torch.profiler`` scope over the host and, where there is a card, its
    kernels; no-op when ``trace_dir`` is None.  Writes ``trace.json`` (a Chrome
    trace) and ``kernels.txt`` (time by kernel, ``key_averages``) into
    ``trace_dir``.  Yields the profiler, or None."""
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
