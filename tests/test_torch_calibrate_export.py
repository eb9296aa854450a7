"""``yolo_cli calibrate`` and ``yolo_cli export`` of the port against the JAX CLI.

``calibrate``: the same seeded YOLOv10-n seg weights (``tests/torch_parity.py
seeded_detector_variables``), saved as each package's ``train`` checkpoint (an
orbax ``step_N`` directory for JAX, a ``step_N.pt`` file for the port), over the
val split of ``write_seg_dataset`` at imgsz 64: ``n_images``, ``n_det``,
``n_tp`` and the four duplicate rates equal, the Platt fit's ``a`` and ``b``
within 1e-4 relative (both fit the same Newton iteration to scores that agree
within 1e-5), the raw thresholds within 1e-4 plus one rounding step of their
four decimals; the sidecar lands where ``YOLO.load_calibration`` reads it.

``export``: ``msgpack`` equal byte for byte to the JAX CLI's export of the same
weights, loaded by the JAX package's ``YOLO`` and predicting as the port does
(boxes 1e-3, scores 1e-5); ``torch`` with the JAX CLI's keys, shapes and
values; ``torch_export`` reloaded by ``torch.export.load`` in an interpreter
where the port cannot be imported, its outputs equal to the eager serving
module's.  The v8/v11 serving function cannot be traced (its NMS sweeps on the
host), so that format refuses them, and the JAX / TensorFlow formats name the
JAX CLI.
"""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import seeded_detector_variables, write_seg_dataset
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.apps import yolo_cli
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, write_msgpack

IMGSZ = 64
FIT_REL = 1e-4
BOX_TOL, SCORE_TOL = 1e-3, 1e-5


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def _frames(root, split):
    import cv2

    return np.stack([cv2.resize(cv2.imread(str(p)), (IMGSZ, IMGSZ))
                     for p in sorted((root / "images" / split).iterdir())])


def _variables(version, root, seed=6):
    return seeded_detector_variables(version, _frames(root, "val"), IMGSZ, seed=seed)


def _port_checkpoint(variables, path):
    """The port's ``step_N.pt`` for the given JAX variables (``Trainer.save_checkpoint``'s layout)."""
    sd = export_yolo_state_dict(variables)
    stats = {k: torch.from_numpy(v) for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    params = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items() if k not in stats}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": params, "batch_stats": stats, "step": 3}, path)
    return path


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------


def _calibration_dataset(root, n_val=6, seed=4):
    """A val split of ``n_val`` 64² PNG frames (noise and a bright rectangle; the
    letterbox is the identity) labelled after the detector: each frame's labels
    are the two best boxes that the seeded YOLOv10-n predicts on it, so that the
    fit sees true positives (random weights hit no drawn object).  Returns the
    weights."""
    import cv2

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.train.data import SegDataset
    from yolo_puncture_tpu_torch.utils.convert import load_yolo_state_dict

    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i in range(n_val):
        img = rng.integers(0, 80, (IMGSZ, IMGSZ, 3)).astype(np.uint8)
        y, x = rng.integers(4, 28, 2)
        img[y:y + rng.integers(12, 34), x:x + rng.integers(12, 34)] = 220
        cv2.imwrite(str(root / "images" / "val" / f"f{i}.png"), img)
    variables = _variables("v10", root)
    det = YOLO("yolov10n-seg", nc=1, device="cpu")
    load_yolo_state_dict(det.model, export_yolo_state_dict(variables))
    ds = SegDataset(str(root), split="val", imgsz=IMGSZ, augment=False)
    for i, (img_path, _) in enumerate(ds.pairs):
        img_u8 = (ds.load(i)["images"][..., ::-1] * 255).astype(np.uint8)      # what calibrate predicts on
        boxes = det.predict(img_u8, conf=0.001, imgsz=IMGSZ, retina_masks=False)[0].boxes.xyxy[:2] / IMGSZ
        with open(root / "labels" / "val" / (os.path.basename(img_path)[:-4] + ".txt"), "w") as f:
            for x1, y1, x2, y2 in boxes:
                f.write("0 " + " ".join(f"{v:.6f}" for v in (x1, y1, x2, y1, x2, y2, x1, y2)) + "\n")
    return variables


def test_calibrate_matches_the_jax_cli(tmp_path, capsys):
    import orbax.checkpoint as ocp

    from apps import yolo_cli as jax_cli
    from yolo_puncture_tpu_torch import YOLO

    root = tmp_path / "data"
    variables = _calibration_dataset(root)
    jdir = tmp_path / "jax" / "step_3"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(jdir), {"params": variables["params"], "batch_stats": variables["batch_stats"], "step": 3})
    ckptr.wait_until_finished()
    argv = ["calibrate", f"data={root}", "arch=yolov10n-seg", f"imgsz={IMGSZ}"]
    ref = jax_cli.main(argv + [f"model={jdir}"])
    ref_lines = _lines(capsys.readouterr().out)
    ckpt = _port_checkpoint(variables, tmp_path / "port" / "step_3.pt")
    got = yolo_cli.main(argv + [f"model={ckpt}"], device="cpu")
    lines = _lines(capsys.readouterr().out)

    sidecar = tmp_path / "port" / "calibration.json"
    assert json.loads(sidecar.read_text()) == json.loads(json.dumps(got))
    for k in ("n_images", "n_det", "n_tp", "duplicate_rate"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["n_images"] == 6 and got["n_det"] > 6 and 6 <= got["n_tp"] < got["n_det"]
    for k in ("a", "b"):
        assert abs(got[k] - ref[k]) <= FIT_REL * abs(ref[k]), (k, got[k], ref[k])
    for u, raw in ref["raw_threshold_at_user_conf"].items():
        assert abs(got["raw_threshold_at_user_conf"][u] - raw) <= 1e-4 * abs(raw) + 1e-4
    assert len(lines) == len(ref_lines) == 3
    assert re.fullmatch(rf"calibration a=-?\d+\.\d{{4}} b=-?\d+\.\d{{4}} over {ref['n_det']} detections "
                        rf"\({ref['n_tp']} TP\) → {re.escape(str(sidecar))}", lines[0])
    assert lines[1].startswith("raw thresholds at user conf: {0.9: ") and lines[2] == ref_lines[2]

    det = YOLO("yolov10n-seg", nc=1, device="cpu")
    assert det.load_calibration(str(tmp_path / "port")) == (got["a"], got["b"])


def test_calibrate_writes_into_a_checkpoint_directory(tmp_path):
    root = write_seg_dataset(tmp_path / "data", n_train=1, n_val=2, seed=4)
    run = tmp_path / "run"
    _port_checkpoint(_variables("v8", root), run / "step_1.pt")
    out = yolo_cli.main(["calibrate", f"data={root}", f"model={run}", "arch=yolov8n-seg", f"imgsz={IMGSZ}",
                         "use_ema=false"], device="cpu")
    assert json.loads((run / "calibration.json").read_text())["n_det"] == out["n_det"]


@pytest.mark.parametrize("cmd", ["val", "calibrate"])
@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_a_checkpoint_that_does_not_fit_raises(tmp_path, cmd, fault):
    """``val`` and ``calibrate`` load a checkpoint strictly: a parameter the
    checkpoint lacks, or a tensor the model lacks, raises instead of leaving the
    seeded weights in place."""
    root = write_seg_dataset(tmp_path / "data", n_train=1, n_val=1, seed=4)
    ckpt = _port_checkpoint(_variables("v8", root), tmp_path / "run" / "step_1.pt")
    payload = torch.load(ckpt, weights_only=True)
    if fault == "missing":
        payload["params"].pop("model.0.conv.weight")
    else:
        payload["batch_stats"]["model.0.extra.running_mean"] = torch.zeros(4)
    torch.save(payload, ckpt)
    with pytest.raises(ValueError, match="state dict does not fit"):
        yolo_cli.main([cmd, f"data={root}", f"model={ckpt}", "arch=yolov8n-seg", f"imgsz={IMGSZ}"], device="cpu")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", ["v8", "v10", "v11"])
def test_yolo_variables_inverts_the_bridge(version):
    """``yolo_variables`` gives back the JAX variable tree that
    ``export_yolo_state_dict`` mapped, leaf for leaf and bit for bit."""
    import jax.numpy as jnp

    from tests.torch_parity import seeded_jax_variables
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.utils.convert import _flatten, yolo_variables

    variables = seeded_jax_variables(JaxYOLOModel(version=version, scale="n", nc=1, task="segment"),
                                     jnp.zeros((1, IMGSZ, IMGSZ, 3)), seed=2)
    back, want = _flatten(yolo_variables(export_yolo_state_dict(variables))), _flatten(variables)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
    model = YOLOModel(version, "n", 1, "segment")          # and from a module's own state dict
    assert sorted(_flatten(yolo_variables(model.state_dict()))) == sorted(want)


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_export_msgpack_and_torch_equal_the_jax_clis(tmp_path, capsys, version):
    from apps import yolo_cli as jax_cli

    root = write_seg_dataset(tmp_path / "data", n_train=1, n_val=2, seed=4)
    weights = tmp_path / f"yolo{version[1:]}n-seg.msgpack"
    write_msgpack(_variables(version, root), str(weights))
    for fmt in ("msgpack", "torch"):
        mine, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
        yolo_cli.main(["export", f"model={weights}", f"format={fmt}", f"output={mine}"], device="cpu")
        jax_cli.main(["export", f"model={weights}", f"format={fmt}", f"output={theirs}"])
        assert _lines(capsys.readouterr().out) == [f"exported to {mine}", f"exported to {theirs}"]
        if fmt == "msgpack":
            assert mine.read_bytes() == theirs.read_bytes()
        else:
            with open(mine, "rb") as f:
                got = pickle.load(f)
            with open(theirs, "rb") as f:
                ref = pickle.load(f)
            assert sorted(got) == sorted(ref)
            for k, r in ref.items():
                assert got[k].shape == r.shape and got[k].dtype == r.dtype and np.array_equal(got[k], r), k


def test_exported_msgpack_predicts_in_the_jax_package_as_in_the_port(tmp_path, monkeypatch):
    """The default output name ``export_<weights>.msgpack`` is parsed by the JAX
    package's ``YOLO``, which predicts from the file as the port does from the
    weights it exported (the seeded weights and frames of
    ``tests/test_torch_predict.py``, 20 detections a frame at conf 0)."""
    from yolo_puncture_tpu.predict import YOLO as JaxYOLO
    from yolo_puncture_tpu_torch import YOLO

    monkeypatch.chdir(tmp_path)
    weights = _seeded_file("seeded_yolov10n-seg.msgpack")
    out = yolo_cli.main(["export", f"model={weights}", "format=msgpack"], device="cpu")
    assert out == f"export_{weights}.msgpack" and os.path.exists(out)
    jdet, port = JaxYOLO(out, nc=1, max_det=20), YOLO(weights, nc=1, max_det=20, device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (2, 96, 160, 3)).astype(np.int32)
    frames[:, 20:60, 30:120] += 150
    for f in np.clip(frames, 0, 255).astype(np.uint8):
        r, j = port.predict(f, conf=0.0, imgsz=IMGSZ)[0], jdet.predict(f, conf=0.0, imgsz=IMGSZ)[0]
        assert len(r.boxes) == len(j.boxes) == 20
        np.testing.assert_allclose(r.boxes.xyxy, j.boxes.xyxy, rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(r.boxes.conf, j.boxes.conf, rtol=0, atol=SCORE_TOL)


def _seeded_file(path):
    """The seeded YOLOv10-n of ``tests/test_torch_predict.py`` as a flax msgpack file."""
    import jax.numpy as jnp

    from tests.torch_parity import seeded_jax_variables
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel

    write_msgpack(seeded_jax_variables(JaxYOLOModel(version="v10", scale="n", nc=1, task="segment"),
                                       jnp.zeros((1, IMGSZ, IMGSZ, 3)), seed=11), str(path))
    return str(path)


def test_torch_export_reloads_without_the_port(tmp_path):
    """``format=torch_export`` of the seeded YOLOv10-n at imgsz 64, batch 2:
    ``torch.export.load`` in an interpreter where ``yolo_puncture_tpu_torch``
    cannot be imported runs it, and its outputs equal the eager serving module's."""
    from yolo_puncture_tpu_torch import YOLO

    root = write_seg_dataset(tmp_path / "data", n_train=1, n_val=2, seed=4)
    weights = _seeded_file(tmp_path / "seeded_yolov10n-seg.msgpack")
    graph = tmp_path / "serve.pt2"
    yolo_cli.main(["export", f"model={weights}", "format=torch_export", f"imgsz={IMGSZ}", "batch=2",
                   f"output={graph}"], device="cpu")
    frames = _frames(root, "val")
    np.save(tmp_path / "frames.npy", frames)
    code = (
        "import sys\n"
        "sys.modules['yolo_puncture_tpu_torch'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"                           # this process's thread count: the same sums
        f"ep = torch.export.load({str(graph)!r})\n"
        f"out = ep.module()(torch.from_numpy(np.load({str(tmp_path / 'frames.npy')!r})))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, *[t.detach().numpy() for t in out])\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert run.returncode == 0, run.stderr
    got = np.load(tmp_path / "out.npz")
    det = YOLO(weights, nc=1, device="cpu")
    with torch.no_grad():
        boxes, scores, classes = (t.numpy() for t in yolo_cli.serving_module(det, IMGSZ)(torch.from_numpy(frames)))
    assert got["arr_0"].shape == (2, det.max_det, 4) and (scores > 0).any()
    np.testing.assert_allclose(got["arr_0"], boxes, atol=BOX_TOL)
    np.testing.assert_allclose(got["arr_1"], scores, atol=SCORE_TOL)
    assert np.array_equal(got["arr_2"], classes)


@pytest.mark.parametrize("model", ["yolov8n-seg", "yolo11n-seg"])
def test_torch_export_refuses_the_nms_models(model):
    """The v8/v11 serving function does not trace (the NMS reads its suppression
    matrix on the host), so the CLI refuses those models with the reason."""
    from yolo_puncture_tpu_torch import YOLO

    with pytest.raises(RuntimeError):
        torch.export.export(yolo_cli.serving_module(YOLO(model, nc=1, device="cpu"), IMGSZ),
                            (torch.zeros((1, IMGSZ, IMGSZ, 3), dtype=torch.uint8),))
    with pytest.raises(SystemExit, match="NMS-free v10"):
        yolo_cli.main(["export", f"model={model}", "format=torch_export", f"imgsz={IMGSZ}"], device="cpu")


@pytest.mark.parametrize("fmt", ["orbax", "stablehlo", "saved_model", "tflite", "onnx"])
def test_jax_formats_raise(fmt):
    with pytest.raises(SystemExit, match="JAX package's CLI" if fmt != "onnx" else "unknown format"):
        yolo_cli.main(["export", "model=yolov10n-seg", f"format={fmt}"], device="cpu")
