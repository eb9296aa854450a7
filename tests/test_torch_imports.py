"""The PyTorch port stands alone: importing any of its modules (or ``chip_smoke.py``)
pulls in neither JAX, flax, msgpack, the JAX package ``yolo_puncture_tpu`` nor its
``apps``, and
every module imports, and the tracker resizes frames and masks, with cv2 out of
reach (the detector's ``ops/geometry.py`` and the predictor's file reader take cv2
only when it is installed); the speed pipeline also runs with cv2 and yaml out of
reach, and the server and the web UI answer PNG uploads with cv2, PIL and gradio
out of reach.

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
FORBIDDEN = ("jax", "flax", "msgpack", "yolo_puncture_tpu", "apps")


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
              "ops.kernels.decode_tail", "ops.resize", "track", "track.network", "track.memory", "track.core",
              "registry", "utils.config", "utils.profiling", "utils.transform", "ops.signal", "ops.geometry",
              "analytics", "analytics.keyframe", "analytics.speed", "analytics.stats", "models.efficientnet",
              "tasks", "tasks.classify", "pipeline", "pipeline.video", "pipeline.runner", "track.saver",
              "utils.png", "utils.plotting", "native", "apps", "apps.track_video", "apps.auto_speed_calc",
              "apps.evaluate_speed", "apps.speed_freq", "apps.serve", "apps.app", "apps.webui", "apps.yolo_cli",
              "models.u2net", "tasks.unet"):
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


def test_pipeline_runs_without_cv2_or_yaml_and_wants_a_card():
    """With jax, flax, yolo_puncture_tpu, cv2 and yaml all out of reach: every module
    imports, ``load_config()`` (no file) pulls in no yaml, the pipeline runs a few
    frames on the CPU (contours from the numpy tracer), and without a card the
    classifier and the detector refuse the default device."""
    code = (
        "import importlib, sys\n"
        f"for m in {FORBIDDEN + ('cv2', 'yaml')!r}: sys.modules[m] = None\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "from yolo_puncture_tpu_torch.utils.config import load_config\n"
        "assert load_config().analytics.judge_wnd == 20\n"
        "import numpy as np, torch\n"
        "from yolo_puncture_tpu_torch import YOLO\n"
        "from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline\n"
        "from yolo_puncture_tpu_torch.tasks import ClassifierNet\n"
        "if not torch.cuda.is_available():\n"
        "    for make in (lambda: ClassifierNet('efficientnet_b0'), lambda: YOLO('yolo10n-seg')):\n"
        "        try:\n"
        "            make()\n"
        "        except RuntimeError:\n"
        "            pass\n"
        "        else:\n"
        "            raise AssertionError('built on the card without a card')\n"
        "pipe = VideoSpeedPipeline(YOLO('yolo10n-seg', nc=1, max_det=8, device='cpu'),\n"
        "                          ClassifierNet('efficientnet_b0', input_size=64, device='cpu'),\n"
        "                          device_batch=2, imgsz=64, crop_size=64)\n"
        "frames = np.random.default_rng(0).integers(0, 255, (3, 48, 80, 3), np.uint8)\n"
        "out = pipe.process_frames(list(frames), fps=30.0, conf=0.0, judge_wnd=2)\n"
        "assert len(out.lens) == 3 and all(out.detected)\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in ('yaml', 'cv2') and sys.modules[k] is not None)\n"
        "assert not leaked, leaked\n"
        "print('pipeline without cv2 or yaml')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("pipeline without cv2 or yaml")


def test_track_video_runs_without_cv2_pil_or_matplotlib(tmp_path):
    """With jax, flax, yolo_puncture_tpu, cv2, PIL and matplotlib all out of reach,
    as on the machine with the card: the tracking app's ``process_frame`` and
    ``process_video_batched`` run decoded frames through a stub detector and the
    tracker on the CPU, the saver writes its PNGs (``utils/png.py``) and
    ``pred.json``, and the host geometry takes the C++ tracer."""
    code = (
        "import importlib, json, os, sys\n"
        f"for m in {FORBIDDEN + ('cv2', 'PIL', 'matplotlib')!r}: sys.modules[m] = None\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from yolo_puncture_tpu_torch.apps import track_video as tv\n"
        "from yolo_puncture_tpu_torch.ops.geometry import mask_to_polygons\n"
        "class Res:\n"
        "    def __init__(self, m):\n"
        "        self.masks = type('M', (), {'data': [m], '__len__': lambda s: 1})()\n"
        "        self.boxes = type('B', (), {'conf': [0.95], 'cls': [0]})()\n"
        "class Det:\n"
        "    def predict(self, im, **kw):\n"
        "        return [Res((np.asarray(im).max(-1) > 200).astype(np.float32))]\n"
        "frames = np.random.default_rng(0).integers(0, 60, (6, 48, 80, 3)).astype(np.uint8)\n"
        "for i, f in enumerate(frames): f[10:30, 10 + 3 * i:40 + 3 * i] = 230\n"
        "pairs = [(f, f'{i:03d}.jpg') for i, f in enumerate(frames)]\n"
        f"out = {str(tmp_path)!r}\n"
        "for batched, setting in ((False, 'online'), (True, 'semionline')):\n"
        "    args = tv.parse_args(['--video_name', 'v', '--img_path', 'unused', '--size', '32', '--output',\n"
        "                          os.path.join(out, setting), '--temporal_setting', setting,\n"
        "                          '--detection_every', '3', '--num_voting_frames', '2']\n"
        "                         + (['--batch_propagation'] if batched else []))\n"
        "    cfg = tv.make_config(args, len(pairs))\n"
        "    tracker = tv.TrackerCore(config=cfg, image_size=(32, 64), max_objects=2, device='cpu')\n"
        "    tracker.next_voting_frame = args.num_voting_frames - 1\n"
        "    tv.track(args, tracker, Det(), pairs)\n"
        "    pred = json.load(open(os.path.join(out, setting, 'pred.json')))\n"
        "    assert len(pred['annotations']) == 6, pred\n"
        "    pngs = os.listdir(os.path.join(out, setting, 'Annotations', 'v'))\n"
        "    assert sorted(pngs) == [f'{i:03d}.png' for i in range(6)], pngs\n"
        "sq = np.zeros((20, 20), np.uint8); sq[5:15, 5:15] = 1\n"
        "assert mask_to_polygons(sq, largest_only=True).tolist() == [[5, 5], [5, 14], [14, 14], [14, 5]]\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in ('cv2', 'PIL', 'matplotlib')\n"
        "                and sys.modules[k] is not None)\n"
        "assert not leaked, leaked\n"
        "print('tracked without cv2, PIL or matplotlib')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("tracked without cv2, PIL or matplotlib")


def test_server_and_web_ui_answer_a_png_without_cv2_pil_or_gradio():
    """With jax, flax, yolo_puncture_tpu, apps, cv2, PIL and gradio all out of
    reach: the server answers a PNG upload
    (and refuses a JPEG with 400), the web UI answers a multipart PNG in image
    mode with a PNG of the annotated image, and ``yolo_cli predict`` reads a
    directory of PNG files."""
    code = (
        "import importlib, json, os, sys, tempfile, urllib.error, urllib.request\n"
        f"for m in {FORBIDDEN + ('cv2', 'PIL', 'gradio')!r}: sys.modules[m] = None\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from yolo_puncture_tpu_torch import YOLO\n"
        "from yolo_puncture_tpu_torch.apps import serve, webui, yolo_cli\n"
        "from yolo_puncture_tpu_torch.utils.png import decode_png, encode_png_rgb\n"
        "rgb = np.random.default_rng(0).integers(0, 255, (40, 56, 3), np.uint8)\n"
        "png = encode_png_rgb(rgb)\n"
        "def post(port, path, data, ctype):\n"
        "    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data, method='POST',\n"
        "                                 headers={'Content-Type': ctype})\n"
        "    try:\n"
        "        with urllib.request.urlopen(req, timeout=120) as r:\n"
        "            return r.status, json.loads(r.read())\n"
        "    except urllib.error.HTTPError as e:\n"
        "        return e.code, json.loads(e.read())\n"
        "srv = serve.Server(YOLO('yolo10n-seg', nc=1, max_det=4, device='cpu'), imgsz=64).start()\n"
        "code, out = post(srv.port, '/predict?conf=0.0&retina=1', png, 'image/png')\n"
        "assert code == 200 and len(out['boxes']) == 4 and out['batch'] == 1, (code, out)\n"
        "refused = post(srv.port, '/predict', b'\\xff\\xd8\\xff\\xe0jpeg', 'image/jpeg')\n"
        "assert refused == (400, {'error': 'could not decode image'}), refused\n"
        "srv.stop()\n"
        "ui = webui.WebUI(imgsz=64, device='cpu').start()\n"
        "b = b'--xx\\r\\nContent-Disposition: form-data; name=\"mode\"\\r\\n\\r\\nimage\\r\\n'\n"
        "b += b'--xx\\r\\nContent-Disposition: form-data; name=\"conf\"\\r\\n\\r\\n0.0\\r\\n'\n"
        "b += b'--xx\\r\\nContent-Disposition: form-data; name=\"file\"; filename=\"f.png\"\\r\\n\\r\\n' + png\n"
        "b += b'\\r\\n--xx--\\r\\n'\n"
        "code, info = post(ui.port, '/analyze', b, 'multipart/form-data; boundary=xx')\n"
        "assert code == 200 and info['mode'] == 'image' and info['detections'] > 0, (code, info)\n"
        "with urllib.request.urlopen(f'http://127.0.0.1:{ui.port}' + info['output_url'], timeout=60) as r:\n"
        "    assert decode_png(r.read()).shape == (40, 56, 3)\n"
        "ui.stop()\n"
        "d = tempfile.mkdtemp()\n"
        "open(os.path.join(d, 'a.png'), 'wb').write(png)\n"
        "assert len(yolo_cli.main(['predict', 'model=yolo10n-seg', f'source={d}', 'imgsz=64'], device='cpu')) == 1\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in ('cv2', 'PIL', 'gradio')\n"
        "                and sys.modules[k] is not None)\n"
        "assert not leaked, leaked\n"
        "print('served without cv2, PIL or gradio')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("served without cv2, PIL or gradio")
