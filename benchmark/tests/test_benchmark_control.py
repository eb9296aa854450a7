"""The control of the correctness check: the fp8 reference in the program's
place has to read not correct, and the program correct, on the same steps.

On the card the cells run at their own size (three seeds each); on the CPU at
the tiny size, where the masks and id maps are too small to separate, the
control reads at least three times as far as the program in the scores, the
boxes and the memory."""

import pytest

from benchmark import control, run as harness
from benchmark.tests.conftest import TINY

CELLS = ["stream.v10s.b128", "stream.v10x.b64"]


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7])
def test_control_reads_farther_than_the_program_tiny(seed):
    r = control.readings("stream.v10s.b128", seed, "cpu", steps=2, program=True, overrides=TINY)
    for k in ("score_gap", "ids_mismatch", "state_gap"):
        assert r["control"][k] >= 3 * r["program"][k], (k, r)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(card, cell):
    limits = harness.load_cell(cell)["limits"]
    for seed in (7001, 7002, 2 ** 31 + 7003):
        r = control.readings(cell, seed, "cuda", program=True)
        assert not harness.judge(r["control"], limits), (seed, r["control"])
        assert harness.judge(r["program"], limits), (seed, r["program"])
