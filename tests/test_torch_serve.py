"""The port's HTTP server (``yolo_puncture_tpu_torch/apps/serve.py``) against
the JAX server (``apps/serve.py``), on the CPU.

Both servers serve the same seeded detector (``tests/torch_parity.py
seeded_detector_variables``, written once as a ``.msgpack`` file that both
``YOLO`` classes read) at imgsz 64, and get the same PNG uploads (cv2 decodes
them on the JAX side, ``utils/png.py decode_png`` on the port's).  The same
request gets the same JSON: ``cls``, ``batch`` and the number of polygons
equal, the boxes within 0.01 after their rounding to 2 decimals, the scores
within 1e-4 after theirs to 4 (fp32 convolutions summed in another order move
a box by about 1e-4 pixels and a score by about 1e-6, which the rounding may
carry over one step).  The polygons are traced from the masks, which the
predict tests hold to 99.9 % equal pixels: at least POLY_EQUAL of them are
equal point for point, and where a mask pixel at the threshold went the other
way (measured: 2 pixels of 3840) the filled polygons agree on POLY_AREA_AGREE
of the frame.  Concurrent requests to the port's server coalesce into padded
batches, and each answer equals a direct ``predict`` of its frame within the
same limits.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import seeded_detector_variables

cv2 = pytest.importorskip("cv2")

IMGSZ, HW = 64, (48, 80)
# one rounding step, plus the float32 error of the rounded values (69.74 is 69.73999786)
BOX_TOL, CONF_TOL = 0.01 + 1e-5, 1e-4 + 1e-7
POLY_AREA_AGREE, POLY_EQUAL = 0.999, 0.9
CONF = 0.05
INT8_SCALE_REL = 1e-4     # the calibrated int8 scales (test_main_serves_int8_after_calib_dir)


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 70, (n, *HW, 3)).astype(np.uint8)
    for i in range(n):
        f[i, 10 + i % 3 * 5:26 + i % 3 * 5, 8 + 4 * i:50 + 4 * i] = 215
    return f


@pytest.fixture(scope="module", params=["v8", "v10"])
def servers(request, tmp_path_factory):
    from flax import serialization

    from apps.serve import Server as JaxServer
    from yolo_puncture_tpu.predict import YOLO as JaxYOLO
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.apps.serve import Server

    version = request.param
    path = tmp_path_factory.mktemp("weights") / f"yolo{version[1:]}n-seg.msgpack"
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(seeded_detector_variables(version, _frames(8, 0), IMGSZ)))
    jdet = JaxYOLO(str(path), nc=1, max_det=8, max_masks=4)
    pdet = YOLO(str(path), nc=1, max_det=8, max_masks=4, device="cpu")
    jsrv = JaxServer(jdet, imgsz=IMGSZ, max_batch=4, window_ms=1.0).start()
    psrv = Server(pdet, imgsz=IMGSZ, max_batch=4, window_ms=300.0).start()
    yield jsrv, psrv, pdet
    jsrv.stop()
    psrv.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _post(server, data: bytes, query=""):
    req = urllib.request.Request(_url(server, "/predict" + query), data=data, method="POST",
                                 headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=60) as r:
        return json.loads(r.read())


def _png(frame):
    return cv2.imencode(".png", frame)[1].tobytes()


def _same_json(got, ref):
    assert set(got) == set(ref) == {"boxes", "conf", "cls", "polygons", "batch"}
    assert got["cls"] == ref["cls"] and got["batch"] == ref["batch"]
    assert len(got["boxes"]) == len(ref["boxes"])
    if ref["boxes"]:
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(got["conf"], ref["conf"], rtol=0, atol=CONF_TOL)
    assert len(got["polygons"]) == len(ref["polygons"])
    for g, r in zip(got["polygons"], ref["polygons"]):
        if g != r:  # a mask pixel at the threshold went the other way: the areas still agree
            fg, fr = np.zeros(HW, np.uint8), np.zeros(HW, np.uint8)
            cv2.fillPoly(fg, [np.array(g, np.int32)], 1)
            cv2.fillPoly(fr, [np.array(r, np.int32)], 1)
            assert (fg == fr).mean() >= POLY_AREA_AGREE
    return sum(g == r for g, r in zip(got["polygons"], ref["polygons"]))


def test_same_requests_give_the_same_json(servers):
    jsrv, psrv, _ = servers
    n_boxes = n_polys = n_equal = 0
    for i, frame in enumerate(_frames(4, seed=1)):
        for query in (f"?conf={CONF}", f"?conf={CONF}&retina=1", f"?conf={CONF}&retina=1&max_polygon=2",
                      f"?conf={CONF}&max_polygon=0"):
            (jc, ref), (pc, got) = _post(jsrv, _png(frame), query), _post(psrv, _png(frame), query)
            assert jc == pc == 200, (ref, got)
            n_equal += _same_json(got, ref)
            n_boxes += len(ref["boxes"])
            n_polys += len(ref["polygons"])
            if "max_polygon=0" in query:
                assert got["polygons"] == []
            if "max_polygon=2" in query:
                assert len(got["polygons"]) <= 2
    assert n_boxes > 0 and n_polys > 0 and n_equal >= POLY_EQUAL * n_polys


def test_concurrent_requests_batch_and_equal_direct_predicts(servers):
    from yolo_puncture_tpu_torch.apps.serve import result_json

    _, psrv, pdet = servers
    before = _get(psrv, "/stats")
    frames = _frames(3, seed=2)
    out = [None] * 3

    def go(i):
        out[i] = _post(psrv, _png(frames[i]), f"?conf={CONF}&retina=1")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    after = _get(psrv, "/stats")
    assert all(code == 200 for code, _ in out)
    assert max(r["batch"] for _, r in out) > 1
    assert after["requests"] - before["requests"] == 3
    assert after["batches"] - before["batches"] < 3                    # at least two shared a batch
    assert after["mean_batch"] == round(after["batched_frames"] / after["batches"], 2)
    for (_, got), frame in zip(out, frames):
        ref = result_json(pdet.predict([frame], conf=CONF, retina_masks=True, imgsz=IMGSZ)[0], got["batch"], -1)
        _same_json(got, ref)


def test_health_stats_and_errors_as_the_jax_server(servers):
    jsrv, psrv, _ = servers
    assert _get(psrv, "/healthz") == _get(jsrv, "/healthz") == {"status": "ok", "platform": "cpu"}
    assert set(_get(psrv, "/stats")) == set(_get(jsrv, "/stats")) == {
        "requests", "batches", "batched_frames", "mean_batch"}
    for srv in (jsrv, psrv):
        assert _post(srv, b"not an image") == (400, {"error": "could not decode image"})
        assert _post(srv, b"", "?conf=0.5")[0] == 400
        assert _post(srv, b"x", "?conf=high") == (400, {"error": "conf must be a float"})
        assert _post(srv, b"x", "?max_polygon=two") == (400, {"error": "max_polygon must be an int"})
        try:
            urllib.request.urlopen(_url(srv, "/nope"), timeout=30)
            raise AssertionError("404 expected")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    # a JPEG goes through cv2 where cv2 is installed, on both servers
    jpeg = cv2.imencode(".jpg", _frames(1, seed=3)[0])[1].tobytes()
    (jc, ref), (pc, got) = _post(jsrv, jpeg, f"?conf={CONF}"), _post(psrv, jpeg, f"?conf={CONF}")
    assert jc == pc == 200
    _same_json(got, ref)


@pytest.mark.parametrize("n,cap", [(1, 16), (2, 16), (3, 16), (5, 16), (9, 16), (16, 16), (17, 16), (3, 4),
                                   (5, 4), (1, 1), (7, 1)])
def test_pad_pow2(n, cap):
    from apps.serve import _pad_pow2 as jax_pad_pow2
    from yolo_puncture_tpu_torch.apps.serve import _pad_pow2

    assert _pad_pow2(n, cap) == jax_pad_pow2(n, cap)
    assert _pad_pow2(n, cap) == min(1 << max(n - 1, 0).bit_length(), cap)


def test_main_serves_int8_after_calib_dir(tmp_path, capsys):
    """``serve --int8 --calib_dir DIR`` (``make_server``, which ``main`` starts)
    against the JAX server that the JAX ``main`` builds from the same flags: the
    same calibration line, the same keys, each scale within ``INT8_SCALE_REL`` of
    JAX's, and the same uploads answered with the same JSON within a rounding
    step once the port serves JAX's scales.  (Each package's own scales differ
    in the last digits, where this seeded network's fp32 activations do, up to
    1.2e-5; a static scale one ulp off moves int8 operands that sit on a
    rounding tie, and through the network scores move by up to 0.055, as far as
    int8 moves them from fp32: ``tests/test_torch_quant.py``.)"""
    from flax import serialization

    from apps.serve import Server as JaxServer
    from yolo_puncture_tpu.predict import YOLO as JaxYOLO
    from yolo_puncture_tpu_torch.apps import serve

    path = tmp_path / "yolo10n-seg.msgpack"
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(seeded_detector_variables("v10", _frames(8, 0), IMGSZ)))
    calib = tmp_path / "calib"
    calib.mkdir()
    for i, frame in enumerate(_frames(3, seed=4)):
        cv2.imwrite(str(calib / f"c{i}.png"), frame)
    psrv, args = serve.make_server(["--int8", "--calib_dir", str(calib), "--weights", str(path), "--host",
                                    "127.0.0.1", "--port", "0", "--imgsz", str(IMGSZ), "--max_batch", "4"],
                                   device="cpu")
    line = capsys.readouterr().out.strip()
    jdet = JaxYOLO(str(path), nc=1, int8_serving=True)
    scales = jdet.calibrate_int8(str(calib), imgsz=IMGSZ)
    assert line == f"int8 calibration: {len(scales)} conv scales frozen from {calib}"
    pscales = psrv.batcher.model._act_scales
    assert psrv.batcher.model.int8_serving and set(pscales) == set(scales)
    assert max(abs(pscales[k] - scales[k]) / scales[k] for k in scales) <= INT8_SCALE_REL
    psrv.batcher.model._act_scales = {k: float(v) for k, v in scales.items()}
    jsrv = JaxServer(jdet, imgsz=IMGSZ, max_batch=4, window_ms=1.0).start()
    psrv.start()
    try:
        n_boxes = 0
        for frame in _frames(2, seed=1):
            for query in (f"?conf={CONF}", f"?conf={CONF}&retina=1"):
                (jc, ref), (pc, got) = _post(jsrv, _png(frame), query), _post(psrv, _png(frame), query)
                assert jc == pc == 200, (ref, got)
                _same_json(got, ref)
                n_boxes += len(ref["boxes"])
        assert n_boxes > 0
    finally:
        jsrv.stop()
        psrv.stop()
    assert torch.get_num_threads() == 1
