"""A cell end to end on the CPU at a tiny size: a well-formed result line, and
``correct`` false for each fault the timed path can have, read by the numbers
that the cells' files hold.

The program runs its kernels' plain versions here.  The limits are the tiny
size's own, on the same numbers as the cells' (whose files hold the full
size's): each sits well above what sound tiny runs read (choice gap 0–3e-4,
the detector's gaps over the witness's: score 4–8, box 15–19, masks 2.9–3.7; id
maps 0.012–0.057 of one frame's pixels, memory ~0.011) and well below what each
fault reads."""

import json

import pytest
import torch

from benchmark import check, run as harness
from benchmark.tests.conftest import TINY

CELLS = ("stream.v10s.b128", "stream.v10x.b64")
TINY_LIMITS = {"choice_gap": 0.01, "score_ratio": 20.0, "box_ratio": 60.0, "mask_ratio": 10.0,
               "ids_frame_max": 0.1, "state_gap": 0.05}
SEED = 2 ** 31 + 4243


def _run(fault=None, trace=False, seconds=1.5):
    return harness.run_cell("stream.v10s.b128", SEED, seconds, trace, device="cpu",
                            overrides={**TINY, "limits": TINY_LIMITS}, fault=fault)


def test_tiny_limits_hold_the_numbers_the_cells_compare():
    assert set(TINY_LIMITS) == set().union(*(harness.load_cell(c)["limits"] for c in CELLS))


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


def _masks_shifted(step):
    """The masks wrong where they are produced (as a fault of the mask decode
    would make them), in every frame: shifted by 4 pixels."""
    def broken(mem, frames, conf, chk):
        out, mem = step(mem, frames, conf, chk)
        return {**out, "mask": torch.roll(out["mask"], 4, dims=-1)}, mem
    return broken


# each fault, and the cells whose numbers have to catch it: a box moved alone is
# caught by ``box_ratio``, which only cell 2 compares (in cell 1 the fp8 control
# reads under three times the program's there; PERF.md, cell correctness)
FAULTS = {"state_unchanged": (_state_unchanged, CELLS), "half_batch": (_half_batch, CELLS),
          "answer_altered": (_answer_altered, CELLS), "boxes_moved": (_boxes_moved, ("stream.v10x.b64",)),
          "masks_shifted": (_masks_shifted, CELLS)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_fault_reads_not_correct(fault):
    plant, cells = FAULTS[fault]
    result, compared = _run(plant)
    assert result["correct"] is False, compared
    numbers = {k: v["value"] for k, v in compared.items()}
    for cell in cells:
        held = {k: TINY_LIMITS[k] for k in harness.load_cell(cell)["limits"]}
        assert not harness.judge(numbers, held), (cell, compared)
