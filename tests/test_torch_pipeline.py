"""The port's video speed pipeline against the JAX package's.

Both pipelines get the same weights: seeded detector variables
(``seeded_detector_variables``, YOLOv8n-seg and YOLOv10n-seg at imgsz 64, as
``tests/test_pipeline.py`` sizes them, BatchNorm statistics of the clip so
that the best score differs from frame to frame) and a seeded EfficientNet-B0 at 96²
(``seeded_classifier_variables``), and the same 96×128 BGR needle clips
(``chip_smoke.needle_clip``).  ``conf`` is chosen between two of the clip's
best scores, so that some frames are detected and some are not.

Tolerances: the device step's float boxes within 1e-3 px and scores within
1e-5, masks at letterbox resolution at least 99.9 % equal per frame,
probabilities within 1e-5 wherever the integer crop origin is the same on both
sides.  End to end, where the integer boxes, the masks and the classes agree
(the seeds below keep every float box edge that is not clipped to the frame at
least 1e-3 px from an integer, which the tests check), lengths and speeds within 1e-9 (the JAX package takes
its C++ calipers, the port numpy's); key frame, end frame, classes, boxes and
the fallback chain exactly equal.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import needle_clip
from tests.torch_parity import seeded_classifier_variables, seeded_detector_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.pipeline import runner as jrun
from yolo_puncture_tpu.pipeline import video as jvid
from yolo_puncture_tpu.predict.predictor import YOLO as JaxYOLO
from yolo_puncture_tpu.tasks.classify import ClassifierNet as JaxClassifierNet
from yolo_puncture_tpu_torch.pipeline import PipelineOutput, VideoReader, VideoSpeedPipeline, sort_key
from yolo_puncture_tpu_torch.predict.predictor import YOLO
from yolo_puncture_tpu_torch.tasks import ClassifierNet
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAMES = {"v8": "yolov8n-seg", "v10": "yolov10n-seg"}
H, W, IMGSZ, CROP, B = 96, 128, 64, 96, 4
BOX_ATOL, CONF_ATOL, MASK_AGREE, PROB_ATOL, LEN_ATOL = 1e-3, 1e-5, 0.999, 1e-5, 1e-9


@functools.lru_cache(maxsize=None)
def _pipes(version):
    """(JAX pipeline, port pipeline) on the same seeded weights, on the CPU."""
    variables = seeded_detector_variables(version, needle_clip(22, H, W, key_frame=8, seed=3)[0], IMGSZ)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxYOLO, "_random_init", lambda self, seed: variables)
        jdet = JaxYOLO(NAMES[version], nc=1, max_det=8)
    pdet = YOLO(NAMES[version], nc=1, max_det=8, device="cpu")
    load_yolo_state_dict(pdet.model, export_yolo_state_dict(variables))
    cvars = seeded_classifier_variables("b0", CROP, seed=7)
    jcls = JaxClassifierNet("efficientnet_b0", input_size=CROP)
    jcls.variables = cvars
    pcls = ClassifierNet("efficientnet_b0", input_size=CROP, variables=cvars, device="cpu")
    kw = dict(device_batch=B, imgsz=IMGSZ, crop_size=CROP)
    return jrun.VideoSpeedPipeline(jdet, jcls, **kw), VideoSpeedPipeline(pdet, pcls, **kw)


def _jax_step(jpipe, batch, conf):
    """The JAX pipeline's step on a batch padded to B, as its loop pads it (one compile)."""
    n = len(batch)
    padded = np.concatenate([batch, np.zeros((B - n, *batch.shape[1:]), batch.dtype)])
    fn = jpipe._step_fn(batch.shape[1:3])
    out = fn(jpipe.detector.variables, jpipe.classifier.variables, jnp.asarray(padded), jnp.float32(conf))
    return {k: np.asarray(v) if k in ("ratio", "pad") else np.asarray(v)[:n] for k, v in out.items()}


def _port_step(ppipe, batch, conf):
    res, r, pad = ppipe._step(torch.from_numpy(batch), conf)
    out = {k: v.numpy() for k, v in res.items() if v is not None}
    out["ratio"], out["pad"] = np.float32(r), np.array(pad, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _clip(version):
    """(frames, conf): a 22-frame clip (five batches of 4 and one of 2) and a
    conf between two of its best scores, at least 1e-3 from each."""
    frames, _, _ = needle_clip(22, H, W, key_frame=8, seed=3)
    jpipe, _ = _pipes(version)
    best = np.sort(np.concatenate([_jax_step(jpipe, frames[i:i + B], 0.0)["conf"] for i in range(0, 22, B)]))
    gaps = np.diff(best)
    i = 5 + int(np.argmax(gaps[5:16]))  # the widest gap with 6 to 16 frames above it
    assert gaps[i] > 2e-3
    return frames, float((best[i] + best[i + 1]) / 2)


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_device_step_matches_jax(version):
    jpipe, ppipe = _pipes(version)
    frames, conf = _clip(version)
    n_valid = n_cls = 0
    for i in range(0, len(frames), B):
        batch = frames[i:i + B]
        got, ref = _port_step(ppipe, batch, conf), _jax_step(jpipe, batch, conf)
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        np.testing.assert_allclose(got["conf"], ref["conf"], rtol=0, atol=CONF_ATOL)
        np.testing.assert_allclose(got["box"], ref["box"], rtol=0, atol=BOX_ATOL)
        # no box edge within reach of an integer, unless both sides clip it to the frame's edge
        near = (np.abs(ref["box"] - np.round(ref["box"])) <= BOX_ATOL) & (got["box"] != ref["box"])
        assert not near[ref["valid"]].any()
        assert got["ratio"] == ref["ratio"] and (got["pad"] == ref["pad"]).all()
        assert got["mask_lb"].dtype == np.uint8 and got["mask_lb"].shape == (len(batch), IMGSZ, IMGSZ)
        for g, r in zip(got["mask_lb"], ref["mask_lb"]):
            assert (g == r).mean() >= MASK_AGREE
        origin = [((b[:, 0] + b[:, 2]) / 2).astype(np.int32) * 10000 + ((b[:, 1] + b[:, 3]) / 2).astype(np.int32)
                  for b in (got["box"], ref["box"])]
        same = origin[0] == origin[1]
        np.testing.assert_array_equal(got["cls"][same], ref["cls"][same])
        np.testing.assert_allclose(got["cls_prob"][same], ref["cls_prob"][same], rtol=0, atol=PROB_ATOL)
        n_valid += int(ref["valid"].sum())
        n_cls += int(same.sum())
    assert 0 < n_valid < len(frames) and n_cls == len(frames)


def _assert_same_output(got: PipelineOutput, ref):
    assert got.detected == ref.detected
    assert got.boxes == [tuple(b) for b in ref.boxes]
    np.testing.assert_allclose(got.lens, ref.lens, rtol=0, atol=LEN_ATOL)
    np.testing.assert_allclose(got.smooth_lens, ref.smooth_lens, rtol=0, atol=LEN_ATOL)
    np.testing.assert_allclose(got.actual_lens, ref.actual_lens, rtol=0, atol=LEN_ATOL, equal_nan=True)
    assert got.classes == ref.classes
    np.testing.assert_allclose(got.probs, ref.probs, rtol=0, atol=PROB_ATOL)
    assert (got.start_frame, got.end_frame, got.fps) == (ref.start_frame, ref.end_frame, ref.fps)
    if ref.speed_mm_s is None:
        assert got.speed_mm_s is None
    else:
        np.testing.assert_allclose(got.speed_mm_s, ref.speed_mm_s, rtol=LEN_ATOL)


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_process_frames_matches_jax(version):
    jpipe, ppipe = _pipes(version)
    frames, conf = _clip(version)
    got = ppipe.process_frames(list(frames), fps=30.0, conf=conf, judge_wnd=5)
    ref = jpipe.process_frames(list(frames), fps=30.0, conf=conf, judge_wnd=5)
    assert 0 < sum(got.detected) < len(frames) and len(got.lens) == len(frames)
    _assert_same_output(got, ref)
    # the fallback chain: an undetected frame repeats the last detection's box and length
    for i in range(1, len(frames)):
        if not got.detected[i]:
            assert got.boxes[i] == got.boxes[i - 1] and got.lens[i] == got.lens[i - 1]
    s = got.start_frame
    assert set(got.classes[:s]) <= {0} and set(got.classes[s + 1:]) <= {1}
    assert {"device_submit", "device_fetch", "host_geometry", "host_classify", "analytics"} <= set(ppipe.timer.summary())


def test_nothing_detected_and_empty_input_match_jax():
    jpipe, ppipe = _pipes("v10")
    frames = [np.zeros((H, W, 3), np.uint8)] * 5
    # above every score: on black frames the seeded detector's sigmoid saturates at 1.0
    got = ppipe.process_frames(frames, fps=30.0, conf=1.5, judge_wnd=3)
    _assert_same_output(got, jpipe.process_frames(frames, fps=30.0, conf=1.5, judge_wnd=3))
    assert not any(got.detected) and got.boxes[0] == (0, 0, W, H) and got.lens == [0.0] * 5
    empty = ppipe.process_frames([], fps=25.0)
    assert dataclasses.asdict(empty) == dataclasses.asdict(jpipe.process_frames([], fps=25.0))
    assert empty.start_frame is None and empty.lens == []


def test_host_pass_on_a_needle_clip_matches_jax():
    """Raw records made from a clip's ground truth (the device step of random
    weights finds nothing useful): the shaft's mask at letterbox resolution,
    192×256 frames at imgsz 256 (pad 32 at the top), four dropouts, two wrong
    classes before the key frame.  Lengths, key frame, end frame and speed are
    held to the JAX package exactly (lengths to 1e-9) and to the clip's truth."""
    jpipe, ppipe = _pipes("v10")
    n, key, fps = 64, 20, 30.0
    frames, boxes, _ = needle_clip(n, 192, 256, key_frame=key, seed=5)
    raw, undetected = [], {}
    for t in range(n):
        mask = np.zeros((256, 256), np.uint8)
        x1, y1, x2, y2 = boxes[t].astype(int)
        mask[y1 + 32:y2 + 32, x1:x2] = 1
        cls = int(t >= key) if t not in (3, 9) else 1
        raw.append({"valid": np.bool_(t not in (5, 12, 45, 46)), "conf": np.float32(0.9), "box": boxes[t],
                    "mask_lb": mask, "cls": np.int32(cls), "cls_prob": np.float32(0.95 if t not in (3, 9) else 0.7),
                    "ratio": np.float32(1.0), "pad": np.array([0.0, 32.0], np.float32)})
        if t in (5, 12, 45, 46):
            undetected[t] = frames[t]
    got = ppipe._host_pass(raw, undetected, (192, 256), fps, 20)
    ref = jpipe._host_pass(raw, undetected, (192, 256), fps, 20)
    _assert_same_output(got, ref)
    assert got.start_frame == key and got.end_frame is not None
    assert got.lens[0] == pytest.approx(float(boxes[0, 3] - boxes[0, 1] - 1))  # pixel centres: one less than the span
    assert got.speed_mm_s == pytest.approx(20.0 * 0.01 * fps, rel=0.1)  # 1 % of 20 mm a frame


def test_interleaved_streams_match_sequential_and_jax():
    _, ppipe = _pipes("v10")
    frames, conf = _clip("v10")
    clips = [("a", 30.0, (H, W), frames[:7]), ("b", 25.0, (H, W), frames[7:12]), ("c", 30.0, (H, W), frames[12:])]
    batched = ppipe._process_streams([(n, f, hw, iter(c)) for n, f, hw, c in clips], conf, 3)
    sequential = ppipe._process_streams([(n, f, hw, iter(c)) for n, f, hw, c in clips], conf, 3, interleave=False)
    assert set(batched) == set(sequential) == {"a", "b", "c"}
    for name, fps, _, c in clips:
        assert len(batched[name].lens) == len(c)
        _assert_same_output(batched[name], sequential[name])


def _write_video(path, frames, fps=30.0):
    import cv2

    out = cv2.VideoWriter(str(path), cv2.VideoWriter.fourcc(*"mp4v"), fps, (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        out.write(f)
    out.release()


def test_process_videos_interleaved_and_mixed_resolutions(tmp_path):
    pytest.importorskip("cv2")
    _, ppipe = _pipes("v10")
    frames, conf = _clip("v10")
    paths = []
    for i, (a, b) in enumerate(((0, 7), (7, 12), (12, 22))):
        paths.append(tmp_path / f"video{i + 1}.mp4")
        _write_video(paths[-1], frames[a:b])
    batched = ppipe.process_videos([str(p) for p in paths], conf=conf, judge_wnd=3, interleave=True)
    sequential = ppipe.process_videos([str(p) for p in paths], conf=conf, judge_wnd=3, interleave=False)
    assert set(batched) == {"video1", "video2", "video3"}
    for name in batched:
        _assert_same_output(batched[name], sequential[name])
    small, _, _ = needle_clip(4, 48, 64, key_frame=2, seed=1)
    _write_video(tmp_path / "small.mp4", small)
    out = ppipe.process_videos([str(paths[1]), str(tmp_path / "small.mp4")], conf=0.9, judge_wnd=3)
    assert len(out["video2"].lens) == 5 and len(out["small"].lens) == 4
    assert out["small"].boxes[0] == (0, 0, 64, 48) or out["small"].detected[0]


def test_detector_and_classifier_must_share_a_device():
    _, ppipe = _pipes("v10")
    with pytest.raises(ValueError, match="one device"):
        VideoSpeedPipeline(ppipe.detector, types.SimpleNamespace(device=torch.device("cuda")))
    assert VideoSpeedPipeline(ppipe.detector).classifier is None


def test_video_reader_and_sort_key_match_jax(tmp_path):
    names = ["12frame_10.jpg", "12frame_2.jpg", "12frame_1.jpg", "frame.jpg", "a3b20.png"]
    assert [sort_key(n) for n in names] == [jvid.sort_key(n) for n in names]
    from PIL import Image

    for i in (3, 1, 20):
        Image.fromarray(np.full((8, 10, 3), i, np.uint8)).save(tmp_path / f"frame_{i}.png")
    (tmp_path / "notes.txt").write_text("ignored")
    got, ref = VideoReader(str(tmp_path)), jvid.VideoReader(str(tmp_path))
    assert got.frames == ref.frames == ["frame_1.png", "frame_3.png", "frame_20.png"]
    for (gi, gp), (ri, rp) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        assert gp == rp
    with pytest.raises(ValueError):
        VideoReader(str(tmp_path / "notes.txt"))

    pytest.importorskip("cv2")
    clip, _, _ = needle_clip(5, 48, 64, key_frame=2, seed=2)
    _write_video(tmp_path / "video7.mp4", clip)
    got, ref = VideoReader(str(tmp_path / "video7.mp4")), jvid.VideoReader(str(tmp_path / "video7.mp4"))
    assert got.frames == ref.frames == [f"7frame_{i}.jpg" for i in range(5)]
    np.testing.assert_array_equal(got[4][0], ref[4][0])
