"""``YOLO.predict`` of the PyTorch port against the JAX package, end to end.

Both predictors get the same seeded variables (the JAX one through its random
init hook, the port through the weight bridge) and the same 96×160 BGR uint8
frames at imgsz 64 (a general-ratio letterbox with a fractional proto pad).
Required: the same counts and classes, boxes within 1e-3 px, scores within
1e-5, and per instance at least 99.9 % of ``masks.data`` pixels equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import seeded_jax_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
from yolo_puncture_tpu.predict.predictor import YOLO as JaxYOLO
from yolo_puncture_tpu_torch.predict.predictor import YOLO, parse_model_name
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

NAMES = {"v10": "yolo10n-seg", "v11": "yolo11n-seg"}


def _frames(n=2, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 60, (n, 96, 160, 3)).astype(np.int32)
    f[:, 20:60, 30:120] += 150  # a bright block gives the detector structure
    f[-1, 50:90, 100:150, 1] += 90
    return np.clip(f, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _variables(version):
    jm = JaxYOLOModel(version=version, scale="n", nc=1, task="segment")
    return seeded_jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=11)


def _pair(version, max_masks, monkeypatch):
    variables = _variables(version)
    monkeypatch.setattr(JaxYOLO, "_random_init", lambda self, seed: variables)
    jdet = JaxYOLO(NAMES[version], nc=1, max_det=20, max_masks=max_masks)
    pdet = YOLO(NAMES[version], nc=1, max_det=20, max_masks=max_masks, device="cpu")
    load_yolo_state_dict(pdet.model, export_yolo_state_dict(variables))
    return jdet, pdet


def _compare(got, ref):
    assert len(got) == len(ref)
    n_total = 0
    for g, r in zip(got, ref):
        assert len(g.boxes) == len(r.boxes)
        n_total += len(r.boxes)
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
        assert g.masks.data.shape == r.masks.data.shape == (len(r.boxes), 96, 160)
        for gm, rm in zip(g.masks.data, r.masks.data):
            assert (gm == rm).mean() >= 0.999
    assert n_total > 0


@pytest.mark.parametrize("version", ["v10", "v11"])
@pytest.mark.parametrize("retina", [False, True])
def test_predict_matches_jax(version, retina, monkeypatch):
    jdet, pdet = _pair(version, 8, monkeypatch)
    frames = list(_frames())
    kw = dict(conf=0.0, iou=0.7, imgsz=64, retina_masks=retina)
    _compare(pdet.predict(frames, **kw), jdet.predict(frames, **kw))


@pytest.mark.parametrize("version", ["v10", "v11"])
def test_calibrated_predict_matches_jax(version, monkeypatch):
    jdet, pdet = _pair(version, 8, monkeypatch)
    for det in (jdet, pdet):
        det.load_calibration((1.7, 2.5))
    frames = list(_frames(seed=1))
    kw = dict(conf=0.3, iou=0.6, imgsz=64)
    got, ref = pdet.predict(frames, **kw), jdet.predict(frames, **kw)
    _compare(got, ref)
    assert all((r.boxes.conf >= 0.3).all() for r in got)


@pytest.mark.parametrize("version", ["v10", "v11"])
def test_overflow_masks_beyond_max_masks_match_jax(version, monkeypatch):
    jdet, pdet = _pair(version, 2, monkeypatch)
    frames = list(_frames(seed=2))
    kw = dict(conf=0.0, imgsz=64, retina_masks=True)
    got, ref = pdet.predict(frames, **kw), jdet.predict(frames, **kw)
    assert len(got[0].boxes) > 2  # more detections than max_masks: the overflow path ran
    _compare(got, ref)


def test_parse_model_name_and_sources():
    assert parse_model_name("seg/yolo11n-seg-finetune.pt") == ("v11", "n", "segment")
    assert parse_model_name("yolov10s") == ("v10", "s", "detect")
    frames, paths = YOLO._to_frames(np.zeros((2, 8, 8, 3), np.float32) + 0.5)
    assert len(frames) == 2 and frames[0].dtype == np.uint8 and frames[0][0, 0, 0] == 128
    assert YOLO._to_frames([]) == ([], [])


def test_results_surface():
    pdet = YOLO("yolo10n-seg", nc=1, max_det=5, max_masks=4, device="cpu")
    r = pdet.predict(_frames(1)[0], conf=0.0, imgsz=64)[0]
    assert len(r) == 5 and r.boxes.xyxy.shape == (5, 4) and r.boxes.xywh.shape == (5, 4)
    assert r.boxes.xyxyn.max() <= 1.0 and r.boxes.cpu().numpy() is r.boxes
    assert r.masks.data.shape == (5, 96, 160) and len(r.masks.xy) == 5
    for poly, polyn in zip(r.masks.xy, r.masks.xyn):
        assert poly.shape[1:] == (2,) and (polyn <= 1.0).all()


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert YOLO("yolo10n-seg", device=None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            YOLO("yolo10n-seg")
    q8 = YOLO("yolo10n-seg", device="cpu", int8_serving=True)           # int8 serving is ported
    assert q8.int8_serving and q8._act_scales is None and q8.device.type == "cpu"


def _matched_mean_err(got, ref):
    """Mean abs difference of two sets of boxes (N, 4) after pairing them up by
    least total L1 distance (the order of nearly equal scores may differ)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(got[:, None, :] - ref[None, :, :]).sum(-1)
    r, c = linear_sum_assignment(cost)
    return float(np.abs(got[r] - ref[c]).mean())


@pytest.mark.parametrize("calibrate", [False, True], ids=["dynamic", "calibrate_int8"])
def test_int8_predict_matches_jax(calibrate, monkeypatch):
    """``YOLO(int8_serving=True).predict`` (dynamic scales, then after
    ``calibrate_int8``) against the JAX predictor's: the same detection counts;
    the scales equal to JAX's within 1e-6; boxes and sorted scores held as
    ``tests/test_torch_quant.py`` holds the heads, within ``DIRECT`` times JAX's
    own int8-versus-fp32 gap (mean abs, the boxes paired up), and the boxes more
    than half that gap from the port's own fp32 predict (an int8 forward ran)."""
    jdet, pdet = _pair("v10", 32, monkeypatch)
    jq8 = JaxYOLO(NAMES["v10"], nc=1, max_det=20, max_masks=32, int8_serving=True)
    frames = _frames()
    kw = dict(conf=0.0, imgsz=64, iou=1.0)
    fp = pdet.predict(list(frames), **kw)
    pdet.int8_serving = True
    if calibrate:
        js, ps = jq8.calibrate_int8(list(frames), imgsz=64), pdet.calibrate_int8(list(frames), imgsz=64)
        assert set(ps) == set(js) and max(abs(ps[k] - js[k]) / js[k] for k in js) <= 1e-6
    ref32, ref8, got = jdet.predict(list(frames), **kw), jq8.predict(list(frames), **kw), pdet.predict(list(frames), **kw)
    for g, r8, r32, f in zip(got, ref8, ref32, fp):
        assert len(g.boxes) == len(r8.boxes) == len(r32.boxes) == len(f.boxes) > 0
        gap_b, err_b = _matched_mean_err(r8.boxes.xyxy, r32.boxes.xyxy), _matched_mean_err(g.boxes.xyxy, r8.boxes.xyxy)
        ran_b = _matched_mean_err(g.boxes.xyxy, f.boxes.xyxy)
        s8, s32, sg = (np.sort(r.boxes.conf) for r in (r8, r32, g))
        gap_s, err_s = float(np.abs(s8 - s32).mean()), float(np.abs(sg - s8).mean())
        print(f"boxes {err_b:.4g} px against a gap of {gap_b:.4g} (port int8 vs fp32 {ran_b:.4g}); "
              f"scores {err_s:.4g} against {gap_s:.4g}")
        assert err_b <= 2.0 * max(gap_b, 1e-6) and err_s <= 2.0 * max(gap_s, 1e-9) and ran_b > 0.5 * gap_b > 0
        assert g.masks.data.shape == r8.masks.data.shape
