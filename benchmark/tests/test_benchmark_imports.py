"""What the harness and the reference load: no JAX, flax or JAX package
anywhere, and the reference nothing of the program.  Names are compared by
their top-level part (before the first dot) whole, since the program's name
begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_puncture_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOP = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_reference_loads_nothing_of_the_program_or_jax():
    mods = _loaded("import benchmark.reference.yolo, benchmark.reference.tracker, benchmark.reference.numerics, "
                   "benchmark.weights, benchmark.reckon, benchmark.check, benchmark.traffic; " + TOP)
    assert not mods & (FORBIDDEN | {"yolo_puncture_tpu_torch"})


def test_the_harness_loads_no_model():
    """``run.py`` knows no model: its system, loaded by name at run time, brings
    the reference, the weights and the program."""
    mods = _loaded("import json, sys, benchmark.run; print(json.dumps(sorted(sys.modules)))")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (FORBIDDEN | {"yolo_puncture_tpu_torch"})
    assert not {m for m in mods if m.startswith(("benchmark.reference", "benchmark.systems"))}
    assert not mods & {"benchmark.weights", "benchmark.check", "benchmark.reckon", "benchmark.traffic"}


def test_a_run_loads_no_jax():
    code = ("import torch; torch.set_num_threads(2); from benchmark import run; "
            f"run.run_cell('stream.v10s.b128', 3, 0.5, True, device='cpu', overrides={TINY!r}); " + TOP)
    mods = _loaded(code)
    assert "yolo_puncture_tpu_torch" in mods
    assert not mods & FORBIDDEN
