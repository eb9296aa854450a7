"""A cell end to end on the CPU at a tiny size: a well-formed result line, and
``correct`` false for each fault the timed path can have.

The program runs its kernels' plain versions here.  The limits are the tiny
size's own (the cells' files hold the full size's): each sits well above what
sound tiny runs read (choice gap 0, score gap 1–3e-4, box 0.12–0.14 px, masks
0–0.03 of their pixels at 64², id maps ~5e-4 of their pixels and 0–4e-4 of
probability, memory ~0.01) and well below what
each fault reads."""

import json

import pytest
import torch

from benchmark import check, run as harness
from benchmark.tests.conftest import TINY

TINY_LIMITS = {"choice_gap": 0.01, "score_gap": 0.002, "box_px": 1.0, "mask_iou_gap": 0.2,
               "ids_frame_max": 0.1, "state_gap": 0.05}
SEED = 2 ** 31 + 4243


def _run(fault=None, trace=False, seconds=1.5):
    return harness.run_cell("stream.v10s.b128", SEED, seconds, trace, device="cpu",
                            overrides={**TINY, "limits": TINY_LIMITS}, fault=fault)


def test_tiny_cell_prints_a_well_formed_line():
    for trace in (False, True):
        result, compared = _run(trace=trace)
        line = json.loads(json.dumps(result))
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "compared" and set(line["compared"]) == set(TINY_LIMITS) <= set(check.NAMES)
        assert line["correct"] is True and line["failed"] == 0 and line["attempted"] % 8 == 0
        want = {m["name"] for m in harness.cell_metrics("stream.v10s.b128", trace)}
        assert set(line["metrics"]) <= want
        if not trace:
            assert set(line["metrics"]) == want          # the host-clock metrics are read on the CPU too
        assert all(v["value"] > 0 for v in line["metrics"].values())


def _state_unchanged(step):
    def broken(mem, frames, conf, chk):
        out, _ = step(mem, frames, conf, chk)
        return out, mem
    return broken


def _half_batch(step):
    def broken(mem, frames, conf, chk):
        out, mem = step(mem, frames[: frames.shape[0] // 2], conf, chk)
        return {k: torch.cat([v, v]) if torch.is_tensor(v) and v.dim() else v for k, v in out.items()}, mem
    return broken


def _answer_altered(step):
    def broken(mem, frames, conf, chk):
        out, mem = step(mem, frames, conf, chk)
        ids = out["ids"].clone()
        ids[0] = 1 - ids[0]
        return {**out, "ids": ids}, mem
    return broken


def _boxes_moved(step):
    """The detector's answer altered where it is produced, in one frame of each
    step: its best box moved by 8 pixels."""
    def broken(mem, frames, conf, chk):
        out, mem = step(mem, frames, conf, chk)
        boxes = out["boxes"].clone()
        boxes[0] += 8.0
        return {**out, "boxes": boxes}, mem
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered, _boxes_moved],
                         ids=["state_unchanged", "half_batch", "answer_altered", "boxes_moved"])
def test_each_fault_reads_not_correct(fault):
    result, compared = _run(fault)
    assert result["correct"] is False, compared
