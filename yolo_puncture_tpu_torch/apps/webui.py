"""The web UI of the puncture pipeline, on the standard library's http.server:
the port's ``apps/webui.py``.

    python -m yolo_puncture_tpu_torch.apps.webui [--port 7860] [--imgsz 640] [--device_batch 8]
    curl -s -F file=@frame.png -F mode=image -F conf=0.9 http://127.0.0.1:7860/analyze

The JAX web UI's endpoints and fields, on the port's ``yolo_inference``:

  GET  /                → HTML form (the controls of the reference's gradio UI)
  POST /analyze         → multipart form {file, mode, conf, judge_wnd, imgsz,
                          crop_size, yolo_model} → JSON {info…, "output_url": …}
  GET  /outputs/<token> → annotated video (mp4) or image (png)
  GET  /healthz         → {"status": "ok"}

In image mode an uploaded PNG is read by ``utils/png.py decode_png`` and the
annotated image written by ``encode_png_rgb``, so image mode runs without cv2;
other image formats, and video mode (an mp4 in and out), need cv2.  Uploads and
results live in a temporary directory of the server; output tokens are random
(``secrets.token_hex``).  ``WebUI(device=None)`` and ``main(argv, device=None)``
run the models on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import email.parser
import email.policy
import json
import os
import secrets
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from yolo_puncture_tpu_torch.utils.png import decode_image, write_png_rgb

_PAGE = """<!doctype html>
<html><head><title>Puncture Detection</title><style>
 body { font-family: sans-serif; max-width: 640px; margin: 2em auto; }
 label { display: block; margin-top: .8em; }
 #result { margin-top: 1.5em; white-space: pre-wrap; }
</style></head><body>
<h1>Puncture Detection</h1>
<form id="f">
 <label>Input file (image or video)
  <input type="file" name="file" required></label>
 <label>Mode
  <select name="mode"><option>video</option><option>image</option></select></label>
 <label>YOLO model
  <input name="yolo_model" value="seg/yolo11n-seg-finetune.pt"></label>
 <label>Confidence threshold
  <input type="number" name="conf" value="0.9" min="0" max="1" step="0.05"></label>
 <label>Judge window
  <input type="number" name="judge_wnd" value="20" min="1"></label>
 <label>Letterbox size
  <input type="number" name="imgsz" value="640" min="32" step="32"></label>
 <label>Classifier crop size
  <input type="number" name="crop_size" value="380" min="32"></label>
 <button type="submit">Analyze</button>
</form>
<div id="result"></div>
<script>
document.getElementById('f').onsubmit = async (e) => {
  e.preventDefault();
  const r = document.getElementById('result');
  r.textContent = 'running…';
  const resp = await fetch('/analyze', {method: 'POST',
    body: new FormData(e.target)});
  const j = await resp.json();
  r.textContent = JSON.stringify(j, null, 2);
  if (j.output_url) {
    const a = document.createElement('a');
    a.href = j.output_url; a.textContent = 'annotated output';
    r.appendChild(document.createElement('br')); r.appendChild(a);
  }
};
</script></body></html>"""


def parse_multipart(content_type: str, body: bytes):
    """multipart/form-data → ({field: str}, {field: (filename, bytes)}): the raw
    body is framed as a MIME message and walked with ``email.parser`` under the
    HTTP policy."""
    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n".encode()
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + body)
    fields, files = {}, {}
    if not msg.is_multipart():
        return fields, files
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        filename = part.get_filename()
        payload = part.get_payload(decode=True)
        if filename:
            files[name] = (filename, payload or b"")
        else:
            fields[name] = (payload or b"").decode("utf-8", "replace").strip()
    return fields, files


class AnalysisStore:
    """Working directory for uploads, and the token-named outputs served back over GET."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="webui_")
        self.lock = threading.Lock()
        self.outputs = {}  # token -> (path, mime)

    def add_output(self, path: str, mime: str) -> str:
        token = secrets.token_hex(8) + os.path.splitext(path)[1]
        with self.lock:
            self.outputs[token] = (path, mime)
        return token


def make_handler(store: AnalysisStore, defaults: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if os.environ.get("SERVE_VERBOSE"):
                super().log_message(fmt, *args)

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/?"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path.startswith("/outputs/"):
                token = os.path.basename(self.path)
                with store.lock:
                    entry = store.outputs.get(token)
                if entry is None:
                    self._json(404, {"error": "unknown output"})
                    return
                path, mime = entry
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    self._json(410, {"error": "output expired"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", mime)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/analyze":
                self._json(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            ctype = self.headers.get("Content-Type", "")
            if length <= 0 or "multipart/form-data" not in ctype:
                self._json(400, {"error": "expected multipart/form-data"})
                return
            fields, files = parse_multipart(ctype, self.rfile.read(length))
            if "file" not in files:
                self._json(400, {"error": "missing 'file' part"})
                return
            filename, payload = files["file"]
            mode = fields.get("mode", "video")
            try:
                conf = float(fields.get("conf", "0.9"))
                judge_wnd = int(fields.get("judge_wnd", "20"))
                imgsz = int(fields.get("imgsz", str(defaults["imgsz"])))
                crop_size = int(fields.get("crop_size", "380"))
            except ValueError:
                self._json(400, {"error": "conf/judge_wnd/imgsz/crop_size must be numeric"})
                return
            upload = os.path.join(store.dir, secrets.token_hex(8) + os.path.splitext(filename)[1])
            with open(upload, "wb") as f:
                f.write(payload)

            from yolo_puncture_tpu_torch.apps.app import yolo_inference

            kwargs = dict(
                yolo_model_id=fields.get("yolo_model", defaults["yolo_model"]),
                yolo_conf_threshold=conf,
                judge_wnd=judge_wnd,
                imgsz=imgsz,
                device_batch=defaults["device_batch"],
                crop_size=crop_size,
                return_info=True,
                device=defaults["device"],
            )
            try:
                if mode == "image":
                    img = decode_image(payload)
                    if img is None:
                        self._json(400, {"error": "could not decode image"})
                        return
                    annotated, _, info = yolo_inference(img[..., ::-1], None, **kwargs)
                    out_path = upload + "_annotated.png"
                    write_png_rgb(out_path, annotated)
                    token = store.add_output(out_path, "image/png")
                else:
                    _, out_path, info = yolo_inference(None, upload, **kwargs)
                    token = store.add_output(out_path, "video/mp4")
            except Exception as e:  # answer with the error, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            info["output_url"] = f"/outputs/{token}"
            self._json(200, info)

    return Handler


class WebUI:
    """Owns the HTTP server; used from Python (tests, the smoke run) or through ``main``."""

    def __init__(self, host="127.0.0.1", port=0, imgsz=640, device_batch=8,
                 yolo_model="seg/yolo11n-seg-finetune.pt", device=None):
        self.store = AnalysisStore()
        defaults = {"imgsz": imgsz, "device_batch": device_batch, "yolo_model": yolo_model, "device": device}
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.store, defaults))
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="Puncture-detection web UI")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)  # gradio's default port
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--device_batch", type=int, default=8)
    p.add_argument("--yolo_model", default="seg/yolo11n-seg-finetune.pt")
    args = p.parse_args(argv)
    ui = WebUI(host=args.host, port=args.port, imgsz=args.imgsz, device_batch=args.device_batch,
               yolo_model=args.yolo_model, device=device)
    ui.start()
    print(f"web UI on http://{args.host}:{ui.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        ui.stop()


if __name__ == "__main__":
    main()
