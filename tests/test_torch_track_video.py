"""The port's ``apps/track_video.py`` against the repository's, end to end on the
CPU: both ``main``s over the same directory of PNG frames (a bright bar that
moves over noise, 96×160, written with cv2), with the shipped needle tracker
checkpoint and a stub detector (the same class for both) that segments the bar
by its brightness at whatever resolution it is handed, as a retina mask.  Both
apps print the same ``Configuration:`` line; ``pred.json`` has the same frames,
ids and categories, and each segment's area within 0.5 % (tracker
probabilities differ by up to 1e-3 between the two packages' fp32 convolutions,
which flips a few boundary pixels); the PNGs' pixels (read with cv2) ≥ 99.9 %
equal.  Modes: online, semi-online, ``--batch_propagation`` in both, both
``--align_voting`` modes, long-term memory off.

Also: the saver's PNGs and ``video_json`` against the JAX ``ResultSaver``;
``get_input_frame_for_deva`` and the float INTER_LINEAR resize of retina masks
against cv2.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import NEEDLE_CHECKPOINT, repo_path

FRAME_HW, N_FRAMES, SIZE = (96, 160), 9, 64
PNG_AGREE = 0.999
AREA_RTOL = 0.005
RESIZE_ATOL = 1e-6  # cv2 sums the two taps of each pass in float32 with its own instruction order


class _Masks:
    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)


class _Boxes:
    def __init__(self, conf, cls):
        self.conf, self.cls = conf, cls


class _Result:
    def __init__(self, masks, conf):
        self.masks = _Masks(masks) if len(masks) else None
        self.boxes = _Boxes(np.asarray(conf, np.float32), np.zeros(len(conf), np.int32))


class BarDetector:
    """``YOLO``'s constructor and ``predict`` surface: one instance, the pixels
    brighter than 200 in a BGR frame, as a float {0, 1} mask at the frame's size."""

    def __init__(self, *args, **kw):
        pass

    def load_calibration(self, src):
        return None

    def predict(self, image_bgr, **kw):
        m = (np.asarray(image_bgr).max(-1) > 200).astype(np.float32)
        return [_Result([m] if m.sum() else [], [0.95] if m.sum() else [])]


def _write_frames(d):
    import cv2

    rng = np.random.default_rng(3)
    h, w = FRAME_HW
    os.makedirs(d, exist_ok=True)
    for i in range(N_FRAMES):
        f = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        f[30:62, 16 + 6 * i:72 + 6 * i] = 230
        cv2.imwrite(os.path.join(d, f"{i:03d}.png"), f)


def _run(pkg, main_mod, monkeypatch, capsys, argv, out_dir):
    import importlib

    monkeypatch.setattr(importlib.import_module(pkg), "YOLO", BarDetector)
    if pkg == "yolo_puncture_tpu_torch":
        main_mod.main(argv + ["--output", out_dir], device="cpu")
    else:
        main_mod.main(argv + ["--output", out_dir])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Configuration:")]
    with open(os.path.join(out_dir, "pred.json")) as f:
        return lines, json.load(f)


MODES = {
    "online": ["--temporal_setting", "online", "--detection_every", "3"],
    "online_batched": ["--temporal_setting", "online", "--detection_every", "3", "--batch_propagation"],
    "semionline": ["--num_voting_frames", "2", "--detection_every", "4"],
    "semionline_batched_no_long_term": ["--num_voting_frames", "2", "--detection_every", "4",
                                        "--batch_propagation", "--disable_long_term"],
    "align_affinity": ["--num_voting_frames", "3", "--detection_every", "4", "--align_voting"],
    "align_propagate": ["--num_voting_frames", "3", "--detection_every", "4", "--align_voting", "propagate"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_track_video_matches_jax(tmp_path, monkeypatch, capsys, mode):
    import cv2

    from apps import track_video as jax_app
    from yolo_puncture_tpu_torch.apps import track_video as port_app

    frames_dir = str(tmp_path / "frames")
    _write_frames(frames_dir)
    argv = ["--video_name", "bar", "--img_path", frames_dir, "--size", str(SIZE), "--model", "yolov8n-seg",
            "--tracker_weights", repo_path(NEEDLE_CHECKPOINT)] + MODES[mode]
    jcfg, jpred = _run("yolo_puncture_tpu.predict", jax_app, monkeypatch, capsys, argv, str(tmp_path / "jax"))
    pcfg, ppred = _run("yolo_puncture_tpu_torch", port_app, monkeypatch, capsys, argv, str(tmp_path / "port"))
    assert pcfg == jcfg and len(pcfg) == 1

    assert ppred["video"] == jpred["video"] == "bar"
    assert [a["file_name"] for a in ppred["annotations"]] == [a["file_name"] for a in jpred["annotations"]]
    assert len(ppred["annotations"]) == N_FRAMES
    n_segments = 0
    for pa, ja in zip(ppred["annotations"], jpred["annotations"]):
        assert [(s["id"], s["category_id"]) for s in pa["segments_info"]] == \
            [(s["id"], s["category_id"]) for s in ja["segments_info"]], pa["file_name"]
        for ps, js in zip(pa["segments_info"], ja["segments_info"]):
            assert abs(ps["area"] - js["area"]) <= AREA_RTOL * js["area"], (pa["file_name"], ps, js)
        n_segments += len(pa["segments_info"])
    assert n_segments >= N_FRAMES - 1          # the bar is tracked through the clip

    for i in range(N_FRAMES):
        name = os.path.join("Annotations", "bar", f"{i:03d}.png")
        got, ref = (cv2.imread(str(tmp_path / side / name)) for side in ("port", "jax"))
        assert got.shape == ref.shape == (*FRAME_HW, 3)
        assert (got == ref).all(-1).mean() >= PNG_AGREE, name


@pytest.mark.parametrize("need_resize", [False, True])
def test_result_saver_matches_jax(tmp_path, need_resize):
    """Same probabilities, same names, same object manager: the PNGs' pixels and
    ``video_json`` equal the JAX saver's exactly."""
    import cv2

    from yolo_puncture_tpu.track import ObjectInfo as JaxObjectInfo
    from yolo_puncture_tpu.track import ObjectManager as JaxObjectManager
    from yolo_puncture_tpu.track.saver import ResultSaver as JaxSaver
    from yolo_puncture_tpu_torch.track import ObjectInfo, ObjectManager, ResultSaver

    rng = np.random.default_rng(5)
    probs = rng.random((4, 5, 33, 47)).astype(np.float32)
    probs[:, 1:] *= 0.6                              # background wins some pixels
    probs[3, 3] = 0                                  # an object with no pixel in the last frame
    managers = []
    for manager_cls, info_cls in ((JaxObjectManager, JaxObjectInfo), (ObjectManager, ObjectInfo)):
        m = manager_cls(4)
        m.allocate(0, info_cls(id=7, category_id=2))
        m.allocate(2, info_cls(id=9))
        managers.append(m)
    out = {}
    for side, saver_cls, manager in (("jax", JaxSaver, managers[0]), ("port", ResultSaver, managers[1])):
        saver = saver_cls(str(tmp_path / side), "vid", object_manager=manager)
        for i, p in enumerate(probs):
            saver.save_mask(p, f"frame{i}.jpg", need_resize=need_resize, shape=(50, 61))
        out[side] = saver.end()
    assert out["port"] == out["jax"]
    assert {s["id"] for a in out["port"]["annotations"] for s in a["segments_info"]} == {7, 9, 2, 4}
    for i in range(len(probs)):
        name = os.path.join("Annotations", "vid", f"frame{i}.png")
        got, ref = (cv2.imread(str(tmp_path / side / name), cv2.IMREAD_UNCHANGED) for side in ("port", "jax"))
        assert got.shape == ref.shape == ((50, 61, 3) if need_resize else (33, 47, 3))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,min_side", [((720, 1280), 480), ((96, 160), 64), ((61, 45), 30), ((40, 40), 0)])
def test_get_input_frame_for_deva_matches_cv2(hw, min_side):
    from yolo_puncture_tpu.track.saver import get_input_frame_for_deva as jax_version
    from yolo_puncture_tpu_torch.track import get_input_frame_for_deva

    frame = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = get_input_frame_for_deva(frame, min_side)
    np.testing.assert_array_equal(got, jax_version(frame, min_side))
    assert got.dtype == np.uint8


@pytest.mark.parametrize("src,dst", [((480, 853), (720, 1280)), ((64, 106), (96, 160)), ((40, 60), (20, 30)),
                                     ((33, 17), (100, 9)), ((7, 5), (7, 11)), ((50, 50), (31, 77))])
def test_float_linear_resize_matches_cv2(src, dst):
    """``resize_linear_f32`` (what ``auto_segment`` resizes each retina mask with)
    against ``cv2.resize(INTER_LINEAR)`` on float32: values within RESIZE_ATOL, on
    soft values and on binary {0, 1} masks, and the ``> 0.5`` pixels equal except
    where cv2's value lies within RESIZE_ATOL of 0.5; one channel and three."""
    import cv2

    from yolo_puncture_tpu_torch.ops.resize import resize_linear_f32

    rng = np.random.default_rng(src[0] * 7 + dst[1])
    soft = rng.random(src).astype(np.float32)
    binary = np.zeros(src, np.float32)
    binary[src[0] // 4:3 * src[0] // 4, src[1] // 5:src[1] // 2 + 1] = 1
    for a in (soft, binary, rng.random((*src, 3)).astype(np.float32)):
        ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = resize_linear_f32(torch.from_numpy(a), dst).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)
        flipped = (got > 0.5) != (ref > 0.5)
        assert not (flipped & (np.abs(ref - 0.5) > RESIZE_ATOL)).any()
