"""The port's import surface against the JAX package's.

Code written against the JAX package (or the reference) imports names from the
package's ``__init__`` files: the same imports must work on the port, the
registry must hold the same model names, ``ops.letterbox`` must stay reachable
as a module where the function shadows it, and ``Results.plot`` must draw the
same pixels.  A copy of ``tests/test_utils_namespace.py`` for the port, the SAM
names (``segment_anything``, ``show_anns``) included.
"""

import importlib

import numpy as np
import pytest

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)

# every import of the JAX package's surface that raised ImportError on the port
SURFACE = [
    ("yolo_puncture_tpu_torch.predict", ["YOLO", "Results", "parse_model_name", "Boxes", "Masks"]),
    ("yolo_puncture_tpu_torch.utils", ["get_config", "segment_anything", "show_anns"]),
    ("yolo_puncture_tpu_torch.models", ["YOLOModel", "VAN"]),
    ("yolo_puncture_tpu_torch.nn", ["Segment"]),
    ("yolo_puncture_tpu_torch.track", ["PropagationNetwork"]),
    ("yolo_puncture_tpu_torch", ["get_config", "create_model", "register_model", "list_models", "YOLO"]),
    ("yolo_puncture_tpu_torch.track.train", ["pyramid_channels_for"]),
]

# each JAX __init__ and the names of it the port leaves out: none since VAN and SAM came
LEFT_OUT = {sub: set() for sub in ("", "predict", "models", "nn", "ops", "utils", "track", "train", "parallel")}


@pytest.mark.parametrize("module,names", SURFACE, ids=[m for m, _ in SURFACE])
def test_the_jax_packages_imports_work_on_the_port(module, names):
    mod = importlib.import_module(module)
    for name in names:
        assert getattr(mod, name) is not None, (module, name)


@pytest.mark.parametrize("sub", sorted(LEFT_OUT))
def test_each_init_exports_the_jax_names(sub):
    """Every public name a JAX ``__init__`` defines (its functions and classes,
    and the names it serves lazily) is on the port's (``LEFT_OUT`` lists none)."""
    jax_mod = importlib.import_module("yolo_puncture_tpu" + (f".{sub}" if sub else ""))
    port = importlib.import_module("yolo_puncture_tpu_torch" + (f".{sub}" if sub else ""))
    lazy = {"": {"YOLO"}, "utils": {"VideoReader", "sort_key"}}.get(sub, set())
    want = {n for n, v in vars(jax_mod).items() if not n.startswith("_") and callable(v)} | lazy
    assert want >= LEFT_OUT[sub] and want
    missing = sorted(n for n in want - LEFT_OUT[sub] if not hasattr(port, n))
    assert not missing, missing


def test_registry_holds_the_jax_names():
    """Right after each package is imported, in a fresh interpreter, the port's
    registry holds exactly the JAX package's 71 names (``van_b0`` … ``van_b6``
    among them); a module imported later may register more (both packages'
    ``models/sam.py`` add ``sam``)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json, yolo_puncture_tpu, yolo_puncture_tpu_torch\n"
            "print(json.dumps([yolo_puncture_tpu.list_models(), yolo_puncture_tpu_torch.list_models()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": root, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    jax_names, port_names = json.loads(out.stdout.strip().splitlines()[-1])
    assert {f"van_b{i}" for i in range(7)} <= set(jax_names) and len(jax_names) == 71
    assert port_names == jax_names


@pytest.mark.parametrize("name,kw,want", [
    ("yolo10s-seg", {"nc": 1}, ("v10", "s", "segment", 1)),
    ("yolov8n", {}, ("v8", "n", "detect", 80)),
    ("yolov10b-seg", {"nc": 3}, ("v10", "b", "segment", 3)),
    ("yolo11x", {"nc": 2, "task_override": "segment"}, ("v11", "x", "segment", 2)),
])
def test_create_model_builds_the_named_yolo(name, kw, want):
    import torch

    from yolo_puncture_tpu_torch import create_model

    m = create_model(name, dtype=torch.bfloat16, **kw)
    assert (m.version, m.scale, m.task, m.nc) == want and m.dtype == torch.bfloat16


def test_create_model_builds_u2net_and_refuses_another_dtype():
    import torch

    from yolo_puncture_tpu_torch import create_model
    from yolo_puncture_tpu_torch.models import U2Net

    small, full = create_model("u2netp"), create_model("u2net")
    assert isinstance(small, U2Net) and full.stage1.rebnconvin.conv_s1.out_channels == 64
    assert small.stage1.rebnconv1.conv_s1.out_channels == 16 and full.stage1.rebnconv1.conv_s1.out_channels == 32
    # bf16 as the JAX package's U2Net(dtype=bfloat16): bf16 convolutions, fp32 BatchNorm
    b16 = create_model("u2netp", dtype=torch.bfloat16)
    assert b16.stage1.rebnconvin.conv_s1.weight.dtype == torch.bfloat16
    assert b16.stage1.rebnconvin.bn_s1.running_var.dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        create_model("u2netp", dtype=torch.float16)


def test_letterbox_module_stays_reachable():
    """``ops.letterbox`` is the function, as in the JAX package; the module is
    reached through ``importlib``, and a monkeypatch by dotted path lands on it."""
    import yolo_puncture_tpu.ops as jops
    import yolo_puncture_tpu_torch.ops as ops

    mod = importlib.import_module("yolo_puncture_tpu_torch.ops.letterbox")
    assert callable(ops.letterbox) and ops.letterbox is mod.letterbox
    assert type(jops.letterbox) is type(ops.letterbox)
    assert mod.__name__ == "yolo_puncture_tpu_torch.ops.letterbox" and hasattr(mod, "letterbox_params")
    assert ops.geometry.__name__ == "yolo_puncture_tpu_torch.ops.geometry"


def test_letterbox_module_can_be_monkeypatched(monkeypatch):
    mod = importlib.import_module("yolo_puncture_tpu_torch.ops.letterbox")
    monkeypatch.setattr(mod, "_MIX_OUT_BLOCK", 7)
    assert importlib.import_module("yolo_puncture_tpu_torch.ops.letterbox")._MIX_OUT_BLOCK == 7


# ---------------------------------------------------------------------------
# the port's copy of tests/test_utils_namespace.py
# ---------------------------------------------------------------------------


def test_all_reference_names_importable():
    import yolo_puncture_tpu_torch.utils as u

    for name in [
        "get_config", "get_coord_min_rect_len", "get_bi_min_rect_len",
        "get_coord_mask", "get_bi_mask", "create_roi_mask", "filter_masks",
        "segment_anything", "show_anns", "gaussian_smoothing", "savitzky_golay_smoothing",
        "difference", "plot_speeds", "compute_metrics", "numpy2tensor",
        "crop_frame", "VideoReader", "sort_key", "load_config", "Config",
    ]:
        assert getattr(u, name) is not None
    assert callable(u.segment_anything) and callable(u.show_anns)


def test_reference_style_usage():
    import yolo_puncture_tpu.utils as ju
    from yolo_puncture_tpu_torch.utils import (
        crop_frame,
        gaussian_smoothing,
        get_config,
        get_coord_mask,
        get_coord_min_rect_len,
        numpy2tensor,
    )

    cfg = get_config()
    assert hasattr(cfg.PATH, "WEIGHTS_PATH")

    poly = [(10, 10), (60, 12), (58, 30), (12, 28)]
    length, ratio = get_coord_min_rect_len(poly)
    assert length > 40 and ratio > 1
    assert np.allclose((length, ratio), ju.get_coord_min_rect_len(poly))

    mask = get_coord_mask((40, 80, 3), poly)
    assert mask.shape == (40, 80, 3) and mask.sum() > 0
    assert np.array_equal(mask, ju.get_coord_mask((40, 80, 3), poly))

    frame = np.zeros((50, 60, 3), np.uint8)
    crop, coords = crop_frame(frame, [10, 10, 30, 30], crop_size=20)
    assert crop.shape[:2] == (20, 20)

    frame = np.random.default_rng(0).integers(0, 255, (50, 60, 3), np.uint8)
    t = numpy2tensor(frame)
    assert t.shape == (3, 50, 60) and t.dtype == np.float32
    assert np.array_equal(t, ju.numpy2tensor(frame))

    sm = gaussian_smoothing([1.0] * 30)
    assert isinstance(sm, list) and len(sm) == 30


# ---------------------------------------------------------------------------
# Results.plot
# ---------------------------------------------------------------------------


def _results(pkg, with_masks=True, n=3):
    rng = np.random.default_rng(5)
    mod = importlib.import_module(f"{pkg}.predict.results")
    h, w = 90, 140
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    x1, y1 = rng.uniform(0, 60, n), rng.uniform(0, 40, n)
    xyxy = np.stack([x1, y1, x1 + rng.uniform(10, 70, n), y1 + rng.uniform(10, 45, n)], 1)
    masks = None
    if with_masks:
        data = np.zeros((n, h, w), np.float32)
        for i, (a, b, c, d) in enumerate(xyxy.astype(int)):
            data[i, b:d, a:c] = 1.0
        masks = mod.Masks(data, (h, w))
    boxes = mod.Boxes(xyxy, rng.uniform(0.2, 1.0, n), np.arange(n) % 2, (h, w))
    return mod.Results(img, boxes, masks, names={0: "needle", 1: "skin"})


@pytest.mark.parametrize("with_masks,n", [(True, 3), (False, 2), (True, 0)])
@pytest.mark.parametrize("cv2_blocked", [False, True])
def test_results_plot_matches_jax_pixels(monkeypatch, with_masks, n, cv2_blocked):
    if cv2_blocked:
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    got = _results("yolo_puncture_tpu_torch", with_masks, n).plot(line_width=2, alpha=0.4)
    ref = _results("yolo_puncture_tpu", with_masks, n).plot(line_width=2, alpha=0.4)
    assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)
    drawn = (got != _results("yolo_puncture_tpu_torch", with_masks, n).orig_img).any()
    assert drawn == (n > 0 and (with_masks or not cv2_blocked))      # boxes only through cv2
