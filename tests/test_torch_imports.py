"""The PyTorch port stands alone: importing any of its modules (or ``chip_smoke.py``)
pulls in neither JAX, flax, msgpack nor the JAX package ``yolo_puncture_tpu``, and
every module imports, and the tracker resizes frames and masks, with cv2 out of
reach (the detector's ``ops/geometry.py`` and the predictor's file reader take cv2
only when it is installed).

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
FORBIDDEN = ("jax", "flax", "msgpack", "yolo_puncture_tpu")


def _port_modules():
    names = [yolo_puncture_tpu_torch.__name__]
    for info in pkgutil.walk_packages(yolo_puncture_tpu_torch.__path__, "yolo_puncture_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _loaded_after_import(modules, forbidden=FORBIDDEN):
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(json.dumps(sorted(k for k in sys.modules if k in {forbidden!r} "
        f"or k.startswith(tuple(f + '.' for f in {forbidden!r})))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_walk_finds_every_layer():
    names = _port_modules()
    for m in ("models.yolo", "nn.common", "nn.heads", "ops.kernels.proto_decode", "ops.masks",
              "predict.predictor", "utils.convert", "_build", "ops.kernels.memory_readout",
              "ops.kernels.decode_tail", "ops.resize", "track", "track.network", "track.memory", "track.core"):
        assert f"yolo_puncture_tpu_torch.{m}" in names


@pytest.mark.parametrize("what", ["package", "chip_smoke"])
def test_no_jax_in_sys_modules(what):
    modules = _port_modules() if what == "package" else ["chip_smoke"]
    assert _loaded_after_import(modules) == []


def test_port_imports_and_tracks_without_cv2():
    code = (
        "import importlib, sys\n"
        "sys.modules['cv2'] = None  # any 'import cv2' now raises ImportError\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore\n"
        "core = TrackerCore(image_size=(32, 64), max_objects=2, mem_frames=2, device='cpu')\n"
        "frame = np.full((45, 90, 3), 99, np.uint8)\n"
        "mask = np.zeros((45, 90), np.int32); mask[10:30, 20:60] = 1\n"
        "prob = core.incorporate_detection(frame, mask, [ObjectInfo(id=1)])\n"
        "assert prob.shape == (3, 32, 64) and core.object_manager.all_obj_ids == [1]\n"
        "print('tracked without cv2')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("tracked without cv2")


def test_build_lists_every_kernel_source():
    """``_build.sources()`` finds the kernels by listing ``csrc/``: no registration per kernel."""
    from yolo_puncture_tpu_torch import _build

    assert _build.sources() == ["decode_tail", "memory_readout", "proto_decode"]
