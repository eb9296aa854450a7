"""The seam between the harness and a system (``systems/__init__.py``): a cell of
another kind of step comes as new files alone (its configuration naming its
system, the system, its traffic mix, the cell) and runs through
``run.run_cell`` unchanged.

The system here is defined in this file: a synchronous step that hands back
variable-length answers on the host (for each row of integers plus the carried
state, the columns that read odd), carries a state (the column sums mod 7),
and is judged by a plain NumPy reference of its own on two numbers of its own.
The harness's lookup is pointed at a directory holding the new files, with the
real metric readers beside them."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import run as harness

CELL = "toy.rows"
SEED = 2 ** 31 + 977
LIMITS = {"rows_wrong": 0, "state_gap": 0.0}


class Rows:
    """The toy system: ``setup(cell, seed, device, mark, fault)`` of the seam."""

    names = ("rows_wrong", "state_gap")

    def __init__(self, cell, seed, device, mark, fault=None):
        tr = self.tr = cell["tr"]
        g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
        self.frames = [torch.randint(0, 10, (tr["rows"], tr["width"]), generator=g).float()
                       for _ in range(tr["distinct_batches"])]
        mark("inputs")
        self.step = self._step if fault is None else fault(self._step)
        mark("program")

    @staticmethod
    def _step(acc, x):
        y = x + acc
        return [torch.nonzero(row % 2 == 1).flatten().tolist() for row in y], (acc + x.sum(0)) % 7

    def initial(self):
        return torch.zeros(self.tr["width"])

    def outputs(self):
        return {}

    def hand(self, i, state, into):
        t_hand = time.perf_counter()
        into["hits"], state = self.step(state, self.frames[i % len(self.frames)])
        t_ret = time.perf_counter()
        return {"hand": t_hand, "ret": t_ret, "done": t_ret, "frames": self.tr["rows"]}, state

    def check(self, checked):
        wrong, gap = 0, 0.0
        for c in checked:
            x, acc = self.frames[c["i"] % len(self.frames)].numpy().astype(np.int64), c["pre"].numpy()
            y = x + acc.astype(np.int64)
            wrong += sum(list(np.flatnonzero(row % 2 == 1)) != got for row, got in zip(y, c["out"]["hits"]))
            gap = max(gap, float(np.abs((acc + x.sum(0)) % 7 - c["post"].numpy()).max()))
        return {"rows_wrong": wrong, "state_gap": gap}

    def step_flops(self):
        return 2 * self.tr["rows"] * self.tr["width"]


@pytest.fixture
def toy_cell(tmp_path, monkeypatch):
    """The new files of a toy cell, and the real metric readers, under a
    directory the harness looks in."""
    files = {
        "configs/toy.json": {"name": "toy", "source": "this test", "system": "toy"},
        "traffic/toy.rows.json": {"rows": 16, "width": 12, "distinct_batches": 3, "check_steps": 2},
        "workloads/toy.rows.json": {"name": CELL, "config": "toy", "traffic": "toy.rows", "chips": 1,
                                    "why": "a toy step of the seam's test", "limits": LIMITS},
    }
    for rel, body in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(body))
    (tmp_path / "systems").mkdir()
    (tmp_path / "systems" / "toy.py").write_text(
        "from benchmark.tests.test_benchmark_systems import Rows as setup  # noqa: F401\n")
    (tmp_path / "metrics").symlink_to(harness.HERE / "metrics")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    return CELL


def _run(cell, trace=False, fault=None):
    return harness.run_cell(cell, SEED, 0.5, trace, device="cpu", fault=fault)


def test_a_synchronous_system_prints_a_well_formed_line(toy_cell):
    result, compared = _run(toy_cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared" and set(line["compared"]) == set(LIMITS)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] % 16 == 0
    assert line["attempted"] >= 16 * (1 + 2)                         # the checked steps at the least
    assert set(line["metrics"]) == {"frames_per_s", "step_latency_ms_p90", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert compared == {k: {"value": 0 if k == "rows_wrong" else 0.0, "limit": v} for k, v in LIMITS.items()}


def test_a_traced_run_reads_no_metric_of_another_system(toy_cell):
    """Every per-layer metric of ``BENCHMARK.json`` lists the cells it reads, so
    a cell of another system reads none of them until it is listed."""
    result, _ = _run(toy_cell, trace=True)
    assert result["correct"] is True and result["metrics"] == {}


def _answer_altered(step):
    def broken(acc, x):
        hits, acc = step(acc, x)
        return [hits[0] + [x.shape[1]]] + hits[1:], acc
    return broken


def _state_unchanged(step):
    def broken(acc, x):
        hits, _ = step(acc, x)
        return hits, acc
    return broken


@pytest.mark.parametrize("fault", [_answer_altered, _state_unchanged], ids=["answer_altered", "state_unchanged"])
def test_a_planted_fault_reads_not_correct(toy_cell, fault):
    result, compared = _run(toy_cell, fault=fault)
    assert result["correct"] is False, compared


def test_limits_on_a_number_the_system_does_not_compare_are_refused(toy_cell, tmp_path):
    path = tmp_path / "workloads" / f"{toy_cell}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "limits": {"choice_gap": 0.005}}))
    with pytest.raises(ValueError, match="choice_gap"):
        _run(toy_cell)
