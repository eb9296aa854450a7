"""The PyTorch port stands alone: importing any of its modules (or ``chip_smoke.py``)
pulls in neither JAX, flax nor the JAX package ``yolo_puncture_tpu``.

Each check runs in a fresh interpreter, since this test process has JAX loaded.
"""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import yolo_puncture_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "yolo_puncture_tpu")


def _port_modules():
    names = [yolo_puncture_tpu_torch.__name__]
    for info in pkgutil.walk_packages(yolo_puncture_tpu_torch.__path__, "yolo_puncture_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _loaded_after_import(modules):
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(json.dumps(sorted(k for k in sys.modules if k in {FORBIDDEN!r} "
        "or k.startswith(('jax.', 'flax.', 'yolo_puncture_tpu.')))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_walk_finds_every_layer():
    names = _port_modules()
    for m in ("models.yolo", "nn.common", "nn.heads", "ops.kernels.proto_decode", "ops.masks",
              "predict.predictor", "utils.convert", "_build"):
        assert f"yolo_puncture_tpu_torch.{m}" in names


@pytest.mark.parametrize("what", ["package", "chip_smoke"])
def test_no_jax_in_sys_modules(what):
    modules = _port_modules() if what == "package" else ["chip_smoke"]
    assert _loaded_after_import(modules) == []
