"""The port's interactive entry points against the JAX package's, on the CPU:
``apps/app.py yolo_inference`` in image and video mode, the saturating add
that stands for ``cv2.addWeighted``, the web UI's ``/analyze`` in both modes,
the gradio wiring (with a gradio double, as ``tests/test_gradio_app.py`` has
it) and ``yolo_cli predict``'s lines.

Both sides read the same files: the seeded YOLO11n seg variables
(``tests/torch_parity.py seeded_detector_variables``) as a ``.msgpack`` file,
a seeded B3 as a timm-keyed ``.pth.tar`` file and a seeded U2NETP as a
torch-named ``.pth`` file (``utils/convert.py export_u2net_state_dict``).
Sizes are cut for the CPU: 96×160 frames, imgsz 64, crops of 64², and the B3
classifier of both apps built at an input size of 96 (its ``ClassifierNet``
swapped on both sides for one with ``input_size=96``).  The annotated video
frames are taken where each app hands them to ``cv2.VideoWriter`` (a recorder
stands in for it on both sides), so that no codec comes between them.

Tolerances: the info dicts equal; annotated pixels at least PIXEL_AGREE equal
(a mask pixel at the threshold may go the other way, as in the predict tests);
the CLI's lines equal.
"""

import functools
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import seeded_classifier_variables, seeded_detector_variables, seeded_u2net_variables
from tests.torch_parity import unet_images

cv2 = pytest.importorskip("cv2")

IMGSZ, HW, CROP, N_FRAMES, CLS_SIZE = 64, (96, 160), 64, 24, 96
PIXEL_AGREE = 0.999


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(directory, detector .msgpack, U2NETP .pth, B3 .pth.tar, clip .mp4, its
    decoded frames, an RGB image)."""
    from flax import serialization

    from chip_smoke import needle_clip
    from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict, export_u2net_state_dict

    d = tmp_path_factory.mktemp("app")
    clip, _, _ = needle_clip(N_FRAMES, *HW, 10, seed=5)
    video = str(d / "clip.mp4")
    out = cv2.VideoWriter(video, cv2.VideoWriter.fourcc(*"mp4v"), 30.0, HW[::-1])
    for f in clip:
        out.write(f)
    out.release()
    cap = cv2.VideoCapture(video)
    decoded = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(f)
    decoded = np.stack(decoded)
    det = str(d / "yolo11n-seg.msgpack")
    with open(det, "wb") as f:
        f.write(serialization.to_bytes(seeded_detector_variables("v11", decoded[::3], IMGSZ)))
    unet = str(d / "u2netp.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                export_u2net_state_dict(seeded_u2net_variables(True, unet_images(CROP, CROP))).items()}, unet)
    cls = str(d / "b3.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in export_classifier_state_dict(
        seeded_classifier_variables("b3", CLS_SIZE)).items()}}, cls)
    image = np.ascontiguousarray(decoded[12][..., ::-1])
    return d, det, unet, cls, video, decoded, image


def _conf_in_a_gap(det, frames):
    """A conf in the widest gap of the frames' best scores (port, fp32), so that
    some frames are detected and some not, none near the threshold."""
    from yolo_puncture_tpu_torch import YOLO

    best = np.sort([float(r.boxes.conf.max()) if len(r.boxes) else 0.0
                    for r in YOLO(det, nc=1, device="cpu").predict(list(frames), conf=0.0, imgsz=IMGSZ)])
    lo, hi = len(best) // 6, len(best) - len(best) // 6
    i = lo + int(np.argmax(np.diff(best)[lo:hi]))
    return float((best[i] + best[i + 1]) / 2)


class _Recorder:
    """Stands in for ``cv2.VideoWriter``: keeps the frames written to each path."""

    written = {}
    fourcc = staticmethod(cv2.VideoWriter.fourcc)

    def __init__(self, path, fourcc, fps, size):
        self.path = path
        _Recorder.written[path] = []

    def write(self, frame):
        _Recorder.written[self.path].append(np.array(frame))

    def release(self):
        pass


@pytest.fixture()
def small_b3(monkeypatch):
    """B3 at an input size of CLS_SIZE in both apps, and the video writer recorded."""
    import yolo_puncture_tpu.tasks as jax_tasks
    import yolo_puncture_tpu_torch.tasks as port_tasks

    monkeypatch.setattr(jax_tasks, "ClassifierNet", functools.partial(jax_tasks.ClassifierNet, input_size=CLS_SIZE))
    monkeypatch.setattr(port_tasks, "ClassifierNet",
                        functools.partial(port_tasks.ClassifierNet, input_size=CLS_SIZE))
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder)
    _Recorder.written = {}


def _agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).all(-1).mean())


def test_image_mode_matches_jax(files):
    from apps.app import yolo_inference as jax_inference
    from yolo_puncture_tpu_torch.apps.app import yolo_inference

    _, det, _, _, _, decoded, image = files
    conf = _conf_in_a_gap(det, decoded)
    kw = dict(yolo_model_id=det, yolo_conf_threshold=conf * 0.5, imgsz=IMGSZ, return_info=True)
    ref_img, ref_vid, ref_info = jax_inference(image, None, **kw)
    got_img, got_vid, got_info = yolo_inference(image, None, device="cpu", **kw)
    assert got_vid is ref_vid is None
    assert got_info == ref_info and ref_info["detections"] > 0
    assert _agree(got_img, ref_img) >= PIXEL_AGREE
    assert (np.asarray(got_img) != image).any()                       # the mask was drawn


def test_video_mode_matches_jax(files, small_b3, capsys):
    from apps.app import yolo_inference as jax_inference
    from yolo_puncture_tpu_torch.apps.app import yolo_inference

    _, det, unet, cls, video, decoded, _ = files
    kw = dict(yolo_model_id=det, unet_seg_model_id=unet, classify_model_id=cls,
              yolo_conf_threshold=_conf_in_a_gap(det, decoded), judge_wnd=5, imgsz=IMGSZ, device_batch=8,
              crop_size=CROP, return_info=True)
    _, ref_path, ref_info = jax_inference(None, video, **kw)
    ref_out = capsys.readouterr().out
    _, got_path, got_info = yolo_inference(None, video, device="cpu", **kw)
    got_out = capsys.readouterr().out
    assert got_info == ref_info and got_out == ref_out
    assert got_info["n_frames"] == N_FRAMES and got_info["start_frame"] is not None
    ref_frames, got_frames = _Recorder.written[ref_path], _Recorder.written[got_path]
    assert len(got_frames) == len(ref_frames) == N_FRAMES
    agree = [_agree(g, r) for g, r in zip(got_frames, ref_frames)]
    assert min(agree) >= PIXEL_AGREE, agree
    # U²-Net's green channel and the ROI's red one were drawn on
    assert any((g.astype(int) - f)[..., 1].max() > 0 for g, f in zip(got_frames, decoded))
    assert any((g.astype(int) - f)[..., 2].max() > 0 for g, f in zip(got_frames, decoded))


@pytest.mark.parametrize("shape", [(7, 9, 3), (40, 64, 3)])
def test_saturating_add_equals_cv2_add_weighted(shape):
    from yolo_puncture_tpu_torch.apps.app import saturating_add

    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = rng.integers(0, 256, shape, dtype=np.uint8)
    b[::2] = 0
    b[1::3] = 255
    np.testing.assert_array_equal(saturating_add(a, b), cv2.addWeighted(a, 1, b, 1, 0))


# ---------------------------------------------------------------------------
# the web UI
# ---------------------------------------------------------------------------


def _multipart(fields: dict, filename: str, payload: bytes):
    boundary = "portboundary42"
    lines = []
    for k, v in fields.items():
        lines += [f"--{boundary}".encode(), f'Content-Disposition: form-data; name="{k}"'.encode(), b"",
                  str(v).encode()]
    lines += [f"--{boundary}".encode(),
              f'Content-Disposition: form-data; name="file"; filename="{filename}"'.encode(),
              b"Content-Type: application/octet-stream", b"", payload, f"--{boundary}--".encode(), b""]
    return b"\r\n".join(lines), f"multipart/form-data; boundary={boundary}"


def _post(port, body, ctype):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/analyze", data=body, method="POST")
    req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fetch(port, url):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}", timeout=60) as r:
        return r.headers["Content-Type"], r.read()


@pytest.fixture()
def uis():
    from apps.webui import WebUI as JaxWebUI
    from yolo_puncture_tpu_torch.apps.webui import WebUI

    jui = JaxWebUI(port=0, imgsz=IMGSZ, device_batch=8).start()
    pui = WebUI(port=0, imgsz=IMGSZ, device_batch=8, device="cpu").start()
    yield jui, pui
    jui.stop()
    pui.stop()


def test_web_ui_image_mode_matches_jax(files, uis):
    from yolo_puncture_tpu_torch.utils.png import decode_png

    _, det, _, _, _, decoded, image = files
    body, ctype = _multipart({"mode": "image", "yolo_model": det, "conf": _conf_in_a_gap(det, decoded) * 0.5},
                             "frame.png", cv2.imencode(".png", image[..., ::-1])[1].tobytes())
    (jc, ref), (pc, got) = (_post(ui.port, body, ctype) for ui in uis)
    assert jc == pc == 200, (ref, got)
    assert {k: v for k, v in got.items() if k != "output_url"} == {k: v for k, v in ref.items() if k != "output_url"}
    assert ref["detections"] > 0
    (jt, jpng), (pt, ppng) = _fetch(uis[0].port, ref["output_url"]), _fetch(uis[1].port, got["output_url"])
    assert jt == pt == "image/png"
    assert _agree(decode_png(ppng), cv2.imdecode(np.frombuffer(jpng, np.uint8), cv2.IMREAD_COLOR)) >= PIXEL_AGREE


def test_web_ui_video_mode_matches_jax(files, uis, small_b3, tmp_path, monkeypatch):
    d, det, unet, cls, video, decoded, _ = files
    with open(video, "rb") as f:
        payload = f.read()
    # the web UI passes no U²-Net or classifier id: both apps look their defaults up under the
    # weights directory (resources/weights, relative to the working directory), so the seeded
    # files are put there for both
    weights = tmp_path / "resources" / "weights"
    os.makedirs(weights / "EfficientNet")
    os.link(unet, weights / "u2netp_finetune_70.pth")
    os.link(cls, weights / "EfficientNet" / "efficientnet_b3.pth.tar")
    monkeypatch.chdir(tmp_path)
    fields = {"mode": "video", "yolo_model": det, "conf": _conf_in_a_gap(det, decoded), "judge_wnd": 5,
              "crop_size": CROP}
    body, ctype = _multipart(fields, "clip.mp4", payload)
    (jc, ref), (pc, got) = (_post(ui.port, body, ctype) for ui in uis)
    assert jc == pc == 200, (ref, got)
    assert {k: v for k, v in got.items() if k != "output_url"} == {k: v for k, v in ref.items() if k != "output_url"}
    assert got["n_frames"] == N_FRAMES and got["mode"] == "video"
    frames = {k: v for k, v in _Recorder.written.items()}
    assert len(frames) == 2
    ref_frames, got_frames = frames.values()
    assert min(_agree(g, r) for g, r in zip(got_frames, ref_frames)) >= PIXEL_AGREE


def test_web_ui_rejects_what_the_jax_web_ui_rejects(uis):
    for ui in uis:
        body, ctype = _multipart({"mode": "image"}, "x.png", b"not an image")
        assert _post(ui.port, body, ctype) == (400, {"error": "could not decode image"})
        assert _post(ui.port, b"x", "text/plain") == (400, {"error": "expected multipart/form-data"})
        body, ctype = _multipart({"mode": "image", "conf": "high"}, "x.png", b"x")
        assert _post(ui.port, body, ctype)[0] == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{ui.port}/", timeout=30) as r:
            assert 'name="judge_wnd"' in r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{ui.port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}


# ---------------------------------------------------------------------------
# the gradio UI
# ---------------------------------------------------------------------------


@pytest.fixture()
def gradio_double(monkeypatch):
    from tests.test_gradio_app import _make_gradio_double

    gr = _make_gradio_double()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


def _wiring(gr, build):
    gr._components.clear()
    gr._contexts.clear()
    demo = build()
    return demo.kind, [c.kind for c in gr._contexts], [
        (c.kind, {k: v for k, v in c.kw.items()}, len(c.change_calls), len(c.click_calls)) for c in gr._components]


def test_gradio_wiring_matches_jax(gradio_double, monkeypatch):
    import apps.app as jax_app
    from yolo_puncture_tpu_torch.apps import app

    assert _wiring(gradio_double, app.build_gradio_app) == _wiring(gradio_double, jax_app.build_gradio_app)
    radio = next(c for c in gradio_double._components if c.kind == "Radio")
    assert [u["visible"] for u in radio.change_calls[0][0]("Image")] == [True, False, True, False]
    calls = []
    monkeypatch.setattr(app, "yolo_inference", lambda *a: calls.append(a) or ("img", "vid"))
    app.build_gradio_app()
    btn = [c for c in gradio_double._components if c.kind == "Button"][-1]
    run = btn.click_calls[0][0]
    assert run("IMG", None, "y.pt", "u.pth", "c.tar", 0.9, 20.0, "Image") == ("img", "vid")
    assert calls[-1] == ("IMG", None, "y.pt", "u.pth", "c.tar", 0.9, 20)
    run(None, "VID.mp4", "y.pt", "u.pth", "c.tar", 0.35, 25.0, "Video")
    assert calls[-1] == (None, "VID.mp4", "y.pt", "u.pth", "c.tar", 0.35, 25) and isinstance(calls[-1][6], int)


def test_main_without_gradio_prints_what_the_jax_app_prints(monkeypatch, capsys):
    import apps.app as jax_app
    from yolo_puncture_tpu_torch.apps import app

    monkeypatch.setitem(sys.modules, "gradio", None)
    jax_app.main()
    ref = capsys.readouterr().out
    app.main()
    assert capsys.readouterr().out == ref and "gradio is not installed" in ref


# ---------------------------------------------------------------------------
# yolo_cli predict
# ---------------------------------------------------------------------------


def test_yolo_cli_predict_prints_what_the_jax_cli_prints(files, capsys, tmp_path):
    from apps import yolo_cli as jax_cli
    from yolo_puncture_tpu_torch.apps import yolo_cli

    _, det, _, _, _, decoded, _ = files
    for i in (0, 7, 15, 23):
        cv2.imwrite(str(tmp_path / f"frame{i:02d}.png"), decoded[i])
    argv = ["predict", f"model={det}", f"source={tmp_path}", f"conf={_conf_in_a_gap(det, decoded) * 0.5:.6f}",
            f"imgsz={IMGSZ}"]
    jax_cli.main(argv)
    ref = capsys.readouterr().out.splitlines()
    results = yolo_cli.main(argv, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(results) == 4
    assert sum(ln.startswith("  cls=") for ln in got) > 0
    assert yolo_cli.parse_kv(["a=1", "b=x=y"]) == jax_cli.parse_kv(["a=1", "b=x=y"]) == {"a": "1", "b": "x=y"}
    for cmd in ("train", "val", "calibrate", "export"):
        with pytest.raises(NotImplementedError, match="item 11"):
            yolo_cli.main([cmd, "model=yolo10n-seg"], device="cpu")
