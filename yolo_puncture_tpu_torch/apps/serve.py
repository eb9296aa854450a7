"""HTTP serving of the detector with dynamic batching: the port's ``apps/serve.py``.

    python -m yolo_puncture_tpu_torch.apps.serve [--weights yolo10s-seg] [--port 8000] [--imgsz 640]
                                                 [--max_batch 16] [--window_ms 5]
    curl -s --data-binary @frame.png -H 'Content-Type: image/png' \
         'http://127.0.0.1:8000/predict?conf=0.25&retina=1&max_polygon=0'

The JAX server's surface, on the standard library's ``http.server``:

  * a collector thread takes requests for up to ``window_ms`` (or
    ``max_batch`` of them), groups them by (frame shape, conf, retina) and runs
    one ``YOLO.predict`` per group, padded to the next power of two
    (≤ ``max_batch``) with copies of its last frame, then hands each request
    its result.  All device work stays on that thread; the HTTP threads decode
    the upload and wait on an event.
  * ``GET /healthz`` → ``{"status": "ok", "platform": "gpu"}`` on the card
    (``"cpu"`` on the CPU, the names ``jax.default_backend()`` uses);
    ``GET /stats`` → the request and batch counters and ``mean_batch``;
    ``POST /predict?conf=0.25&retina=0&max_polygon=-1`` with the image bytes →
    ``{"boxes", "conf", "cls", "polygons", "batch"}`` (boxes and polygons
    rounded to 2 decimals, scores to 4; ``max_polygon`` -1 all, 0 none, N the
    first N).
  * uploads: a PNG file is read by ``utils/png.py decode_png`` wherever the
    server runs; other formats by ``cv2.imdecode`` where cv2 is installed;
    bytes that neither reads get 400 ``could not decode image``.

``--int8`` keeps the JAX server's flag: int8 serving is not ported, and
``YOLO(int8_serving=True)`` raises.  ``Server(model=None, device=None)`` and
``main(argv, device=None)`` run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from yolo_puncture_tpu_torch.utils.png import decode_image


class _Request:
    __slots__ = ("frame", "conf", "retina", "max_polygon", "event", "result", "error")

    def __init__(self, frame, conf, retina, max_polygon=-1):
        self.frame = frame
        self.conf = conf
        self.retina = retina
        self.max_polygon = max_polygon  # -1 = all, 0 = none, N = first N
        self.event = threading.Event()
        self.result = None
        self.error = None


def _pad_pow2(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def result_json(res, n: int, max_polygon: int) -> dict:
    """One ``Results`` → the response body of the JAX server (``n`` is the
    group's request count)."""
    boxes = res.boxes
    out = {
        "boxes": np.asarray(boxes.xyxy).round(2).tolist(),
        "conf": np.asarray(boxes.conf).round(4).tolist(),
        "cls": np.asarray(boxes.cls).astype(int).tolist(),
        "batch": n,
    }
    if res.masks is not None and max_polygon != 0:
        xy = res.masks.xy
        if max_polygon > 0:
            xy = xy[:max_polygon]
        out["polygons"] = [np.asarray(p).round(2).tolist() for p in xy]
    else:
        out["polygons"] = []
    return out


class Batcher(threading.Thread):
    """Collect requests for up to ``window_ms``, run them as padded device
    batches grouped by (shape, conf, retina)."""

    def __init__(self, model, imgsz: int = 640, max_batch: int = 16, window_ms: float = 5.0):
        super().__init__(daemon=True)
        self.model = model
        self.imgsz = imgsz
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_frames": 0}
        self._halt = threading.Event()  # not _stop: Thread.join calls a method of that name

    def submit(self, req: _Request) -> None:
        self.q.put(req)

    def stop(self) -> None:
        self._halt.set()
        self.q.put(None)  # wake the collector

    def _collect(self):
        first = self.q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_ms / 1e3
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def run(self):
        while not self._halt.is_set():
            batch = self._collect()
            if not batch:
                continue
            groups = {}
            for r in batch:
                groups.setdefault((r.frame.shape, r.conf, r.retina), []).append(r)
            for (_, conf, retina), reqs in groups.items():
                try:
                    self._run_group(reqs, conf, retina)
                except Exception as e:  # report to the waiting requests, keep serving
                    for r in reqs:
                        if r.event.is_set():
                            continue  # already answered
                        r.error = f"{type(e).__name__}: {e}"
                        r.event.set()
        # shutdown: fail whatever is still queued so that no handler waits for its timeout
        while True:
            try:
                r = self.q.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.event.is_set():
                r.error = "server shutting down"
                r.event.set()

    def _run_group(self, reqs, conf, retina):
        n = len(reqs)
        padded = _pad_pow2(n, self.max_batch)
        frames = [r.frame for r in reqs] + [reqs[-1].frame] * (padded - n)
        results = self.model.predict(source=frames, conf=conf, retina_masks=retina, imgsz=self.imgsz)
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["batched_frames"] += padded
        for r, res in zip(reqs, results[:n]):
            r.result = result_json(res, n, r.max_polygon)
            r.event.set()


def make_handler(batcher: Batcher, timeout_s: float = 60.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet unless SERVE_VERBOSE is set
            if os.environ.get("SERVE_VERBOSE"):
                super().log_message(fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                platform = "gpu" if batcher.model.device.type == "cuda" else "cpu"
                self._json(200, {"status": "ok", "platform": platform})
            elif path == "/stats":
                s = dict(batcher.stats)
                s["mean_batch"] = round(s["batched_frames"] / max(s["batches"], 1), 2)
                self._json(200, s)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            qs = parse_qs(parsed.query)
            try:
                conf = float(qs.get("conf", ["0.25"])[0])
            except ValueError:
                self._json(400, {"error": "conf must be a float"})
                return
            retina = qs.get("retina", ["0"])[0] not in ("0", "false", "")
            try:
                max_polygon = int(qs.get("max_polygon", ["-1"])[0])
            except ValueError:
                self._json(400, {"error": "max_polygon must be an int"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "empty body (send JPEG/PNG bytes)"})
                return
            frame = decode_image(self.rfile.read(length))
            if frame is None:
                self._json(400, {"error": "could not decode image"})
                return
            req = _Request(frame, conf, retina, max_polygon)
            batcher.submit(req)
            if not req.event.wait(timeout_s):
                self._json(504, {"error": "inference timeout"})
                return
            if req.error is not None:
                self._json(500, {"error": req.error})
                return
            self._json(200, req.result)

    return Handler


class Server:
    """Owns the HTTP server and the batcher; used from Python (tests, the smoke
    run) or through ``main``.  ``model`` defaults to ``YOLO("yolo10s-seg",
    nc=1)`` on ``device``."""

    def __init__(self, model=None, host="127.0.0.1", port=0, imgsz=640,
                 max_batch=16, window_ms=5.0, timeout_s=300.0, device=None):
        if model is None:
            from yolo_puncture_tpu_torch import YOLO

            model = YOLO("yolo10s-seg", nc=1, device=device)
        self.batcher = Batcher(model, imgsz=imgsz, max_batch=max_batch, window_ms=window_ms)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.batcher, timeout_s=timeout_s))
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self):
        self.batcher.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
        self.batcher.join(timeout=60)


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="detector serving")
    p.add_argument("--weights", default="yolo10s-seg")
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--window_ms", type=float, default=5.0)
    p.add_argument("--int8", action="store_true", help="int8 conv serving path (not ported: raises)")
    p.add_argument("--calib_dir", default=None,
                   help="directory of representative frames for int8 calibration (with --int8)")
    args = p.parse_args(argv)

    from yolo_puncture_tpu_torch import YOLO

    model = YOLO(args.weights, nc=args.nc, int8_serving=args.int8, device=device)
    server = Server(model, host=args.host, port=args.port, imgsz=args.imgsz,
                    max_batch=args.max_batch, window_ms=args.window_ms)
    server.start()
    print(f"serving {args.weights} on {args.host}:{server.port} "
          f"(imgsz={args.imgsz}, max_batch={args.max_batch})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
