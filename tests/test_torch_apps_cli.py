"""The port's batch CLIs against the repository's, on the CPU: the same argv,
the same clips (needle videos written with cv2, decoded by cv2 on both sides)
and the same weights carried across, so the printed lines must be equal:

  * ``auto_speed_calc``: the seeded YOLOv8n seg variables
    (``tests/torch_parity.py seeded_detector_variables``) as a ``.msgpack`` file
    and a seeded B3 as a timm-keyed ``.pth.tar`` file, both read by both apps,
    at imgsz 64, over two videos through the shared batches: with the bf16
    networks the app builds, key frames within one frame and speeds within 15 %;
    with fp32 ones swapped in on both sides, every line equal;
  * ``evaluate_speed``: ``--det_init`` / ``--cls_init`` msgpack variables over an
    fp32 pipeline (``--cls_model efficientnet_b0 --crop_size 96``), ground truth
    from ``--key_frames``; every line equal;
  * ``speed_freq``: the histogram PNGs' pixels equal, and the lines equal;
  * ``utils/plotting.py plot_speeds``: the PNG's pixels equal;
  * the port's copy of ``KEY_FRAME`` equals ``tools/toolbox.py``'s.
"""

import json
import os
import pickle
import re

import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import seeded_classifier_variables, seeded_detector_variables

IMGSZ, HW, N_FRAMES = 64, (96, 160), 40
# an end frame one later or earlier changes a speed over some ten frames by a tenth
SPEED_BF16_RTOL = 0.15


def _write_video(path, frames):
    import cv2

    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*"mp4v"), 30.0, (w, h))
    for f in frames:
        out.write(f)
    out.release()


def _decoded(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    return np.stack(frames)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two needle videos (video1, video2) and a video without a number; the
    seeded detector's variables, with BatchNorm statistics of the decoded frames."""
    from chip_smoke import needle_clip

    d = tmp_path_factory.mktemp("clips")
    for name, seed, key in (("video1", 1, 12), ("video2", 2, 16), ("clip", 3, 10)):
        frames, _, _ = needle_clip(N_FRAMES, *HW, key, seed=seed)
        _write_video(d / f"{name}.mp4", frames)
    decoded = np.concatenate([_decoded(d / f"video{i}.mp4") for i in (1, 2)])
    det = seeded_detector_variables("v8", decoded[::4], IMGSZ)
    return d, det


def _msgpack(path, variables):
    from flax import serialization

    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    return str(path)


def _lines(capsys, fn, argv, **kw):
    fn(argv, **kw)
    lines = capsys.readouterr().out.splitlines()
    with capsys.disabled():
        print("\n".join(lines))
    return lines


def _best_score_gap(det_path, clip_dir):
    """A conf in the widest gap of the videos' best raw scores (port, fp32), so
    that some frames are detected and some not, none near the threshold."""
    from yolo_puncture_tpu_torch import YOLO

    yolo = YOLO(det_path, nc=1, device="cpu")
    best = []
    for i in (1, 2):
        for r in yolo.predict(_decoded(clip_dir / f"video{i}.mp4"), conf=0.0, imgsz=IMGSZ):
            best.append(float(r.boxes.conf.max()) if len(r.boxes) else 0.0)
    best = np.sort(best)
    lo, hi = len(best) // 8, len(best) - len(best) // 8
    i = lo + int(np.argmax(np.diff(best)[lo:hi]))
    return float((best[i] + best[i + 1]) / 2)


def _fp32_pipeline(pkg):
    """``build_pipeline``'s signature, building ``pkg``'s fp32 pipeline with a B0
    at 96² (the exact form of the comparison)."""
    import importlib

    yolo = importlib.import_module(f"{pkg}.predict.predictor").YOLO
    pipeline = importlib.import_module(f"{pkg}.pipeline").VideoSpeedPipeline
    classifier = importlib.import_module(f"{pkg}.tasks").ClassifierNet
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}

    def build(yolo_model, classify_model, device_batch, imgsz, **_):
        return pipeline(yolo(yolo_model, nc=1, **kw), classifier("efficientnet_b0", input_size=96, **kw),
                        device_batch=device_batch, imgsz=imgsz, crop_size=96)
    return build


SPEED_LINE = re.compile(r"^(\S+):  (\S+)-(\S+)  (?:([0-9.]+)mm/s|n/a)$")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_auto_speed_calc_prints_what_the_jax_app_prints(clips, tmp_path, capsys, monkeypatch, dtype):
    """bf16 (the app as it is built: YOLOv8n seg and B3 at 380²): the same
    ``Processing video:`` lines, each video's key frames within one frame and its
    speed within SPEED_BF16_RTOL (both sides round every layer to bf16, XLA on
    the CPU inside its own fusions, so the lengths move by a fraction of a pixel
    and the end frame, where the length crosses 18 mm, may move by one).  fp32
    (``build_pipeline`` swapped on both sides for an fp32 one with a B0 at 96²):
    every line equal."""
    from apps import auto_speed_calc as jax_app
    from yolo_puncture_tpu_torch.apps import auto_speed_calc as port_app
    from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict

    clip_dir, det = clips
    os.makedirs(tmp_path / "videos")
    for i in (1, 2):
        os.link(clip_dir / f"video{i}.mp4", tmp_path / "videos" / f"video{i}.mp4")
    det_path = _msgpack(tmp_path / "yolov8n-seg.msgpack", det)
    cls_path = str(tmp_path / "b3.pth.tar")
    if dtype == "bfloat16":
        cls = {k: torch.from_numpy(np.asarray(v)) for k, v in
               export_classifier_state_dict(seeded_classifier_variables("b3", 380)).items()}
        torch.save({"state_dict": cls}, cls_path)
    else:
        monkeypatch.setattr(jax_app, "build_pipeline", _fp32_pipeline("yolo_puncture_tpu"))
        monkeypatch.setattr(port_app, "build_pipeline", _fp32_pipeline("yolo_puncture_tpu_torch"))
    conf = _best_score_gap(det_path, clip_dir)
    argv = ["-p", str(tmp_path / "videos"), "-ym", det_path, "-cm", cls_path,
            "-yct", f"{conf:.6f}", "-jw", "5", "--batch", "8", "--imgsz", str(IMGSZ)]
    ref = _lines(capsys, jax_app.main, argv)
    got = _lines(capsys, port_app.main, argv, device="cpu")
    assert len(got) == 4 and all(SPEED_LINE.match(ln) for ln in got[2:]), got
    if dtype == "float32":
        assert got == ref
        return
    assert got[:2] == ref[:2]
    for g, r in zip(map(SPEED_LINE.match, got[2:]), map(SPEED_LINE.match, ref[2:])):
        assert r is not None and g.group(1) == r.group(1), (g.group(0), r.group(0))
        for k in (2, 3):
            assert (g.group(k) == r.group(k) == "None"
                    or abs(int(g.group(k)) - int(r.group(k))) <= 1), (g.group(0), r.group(0))
        assert (g.group(4) is None) == (r.group(4) is None)
        if r.group(4):
            assert abs(float(g.group(4)) - float(r.group(4))) <= SPEED_BF16_RTOL * float(r.group(4)), \
                (g.group(0), r.group(0))


def test_evaluate_speed_prints_what_the_jax_app_prints(clips, tmp_path, capsys):
    from apps import evaluate_speed as jax_app
    from yolo_puncture_tpu_torch.apps import evaluate_speed as port_app

    clip_dir, det = clips
    det_path = _msgpack(tmp_path / "yolov8n-seg-init.msgpack", det)
    cls_path = _msgpack(tmp_path / "cls.msgpack", seeded_classifier_variables("b0", 96))
    with open(tmp_path / "kf.json", "w") as f:
        json.dump({"1": [12, 30], "2": [16, 34]}, f)
    conf = _best_score_gap(det_path, clip_dir)
    argv = ["-p", str(clip_dir), "-ym", "yolov8n-seg", "-yct", f"{conf:.6f}", "-jw", "5", "--imgsz", str(IMGSZ),
            "--batch", "8", "--key_frames", str(tmp_path / "kf.json"), "--det_init", det_path,
            "--cls_init", cls_path, "--cls_model", "efficientnet_b0", "--crop_size", "96"]
    ref = _lines(capsys, jax_app.main, argv)
    got = _lines(capsys, port_app.main, argv, device="cpu")
    assert got == ref
    assert got[0] == "clip: no ground truth, skipping" and len(got) >= 2


def test_speed_freq_writes_what_the_jax_app_writes(tmp_path, capsys):
    import cv2

    from apps import speed_freq as jax_app
    from yolo_puncture_tpu_torch.apps import speed_freq as port_app

    rng = np.random.default_rng(0)
    d = tmp_path / "in"
    d.mkdir()
    for name, data in (("video1", {"lens": list(100.0 + rng.normal(0, 1, 30)) + list(100 - 2.0 * np.arange(20)),
                                   "key_frame": (30, 40)}),
                       ("video2", {"lens": [80.0] * 25, "key_frame": (0, 10), 0: 0.25}),
                       ("video3", {"lens": [80.0] * 25, "key_frame": (0, 10)}),
                       ("video4", {"lens": [80.0] * 25, "key_frame": (None, 10)})):
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(data, f)
    out = {}
    for side, fn in (("jax", jax_app.main), ("port", port_app.main)):
        lines = _lines(capsys, fn, ["--input", str(d), "--output", str(tmp_path / side)])
        out[side] = sorted(ln.replace(str(tmp_path / side), "<out>") for ln in lines)
    assert out["port"] == out["jax"]
    written = sorted(os.listdir(tmp_path / "jax"))
    assert written == sorted(os.listdir(tmp_path / "port")) == ["video1.png", "video2.png"]
    for name in written:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name)), cv2.imread(str(tmp_path / "jax" / name)))


def test_plot_speeds_draws_what_the_jax_version_draws(tmp_path):
    import cv2

    from yolo_puncture_tpu.utils.plotting import plot_speeds as jax_plot
    from yolo_puncture_tpu_torch.utils.plotting import plot_speeds

    lens = list(100.0 + np.random.default_rng(1).normal(0, 1, 40)) + list(100 - 2.0 * np.arange(30))
    jax_plot(lens, (40, 52), act_range=(41, 55), file_path=str(tmp_path / "jax.png"))
    plot_speeds(lens, (40, 52), act_range=(41, 55), file_path=str(tmp_path / "port.png"))
    got, ref = cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "jax.png"))
    assert got is not None and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_key_frame_copy_equals_the_toolbox():
    from tools.toolbox import KEY_FRAME
    from yolo_puncture_tpu_torch.apps.evaluate_speed import KEY_FRAME as port_key_frame

    assert port_key_frame == KEY_FRAME
