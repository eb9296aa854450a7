"""Ultralytics-compatible predictor: ``YOLO(weights).predict(...)`` on the GPU.

Counterpart of ``yolo_puncture_tpu/predict/predictor.py``.  Accepts ndarray /
PIL / path / directory / video sources (PNG files are read by ``utils/png.py``,
the other files by cv2) and ``conf``, ``iou``, ``retina_masks``,
``imgsz``; returns one ``Results`` per frame with boxes and masks in original
frame coordinates.  Per batch of same-shape frames, on the device:

  letterbox (+ BGR→RGB, /255) → YOLOModel → NMS-free top-k (v10) or NMS (v8/v11)
  → optional Platt score remap → proto-mask decode (the CUDA kernel) → paste to
  the original frame (crop at original resolution for retina) → threshold

PyTorch runs eagerly, so there is no per-geometry compiled-program cache.  The
model runs on ``cuda`` unless the caller passes ``device="cpu"``, in ``dtype``
(fp32, or bf16 as the apps build it): a bf16 model gets a bf16 letterbox, and
its masks are decoded, pasted, cropped and thresholded in bf16, as the JAX
package's predictor does.

``int8_serving=True`` runs the model's forward under ``nn/quant.py
int8_convs``: its ``ConvBN`` convolutions become int8 products, with dynamic
activation scales, or static ones after ``calibrate_int8``; the rest of
``predict`` is unchanged, and the masks still decode through the
``proto_decode`` kernel.  Dynamic scales are taken over the whole batch, so a
frame's boxes depend on the frames it is batched with, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.models.yolo import YOLOModel
from yolo_puncture_tpu_torch.nn.quant import collect_act_scales, freeze_int8_weights, int8_convs
from yolo_puncture_tpu_torch.ops.letterbox import letterbox, letterbox_params, scale_boxes
from yolo_puncture_tpu_torch.ops.masks import crop_masks, decode_masks, paste_masks_to_original
from yolo_puncture_tpu_torch.ops.nms import select_detections
from yolo_puncture_tpu_torch.predict.results import Boxes, Masks, Results
from yolo_puncture_tpu_torch.utils.convert import (
    export_yolo_state_dict,
    extract_state_dict,
    load_yolo_state_dict,
    read_msgpack,
)
from yolo_puncture_tpu_torch.utils.device import resolve_device
from yolo_puncture_tpu_torch.utils.png import decode_png

_NAME_RE = re.compile(r"yolo(?:v)?(\d+)([nsmblx])(-seg)?", re.IGNORECASE)


def parse_model_name(name: str) -> Tuple[str, str, str]:
    """'seg/yolo11n-seg-finetune.pt' → ('v11', 'n', 'segment')."""
    base = os.path.basename(str(name))
    m = _NAME_RE.search(base)
    if not m:
        raise ValueError(f"cannot parse model name from '{name}'")
    version = f"v{m.group(1)}"
    if version not in ("v8", "v10", "v11"):
        raise ValueError(f"unsupported YOLO version '{version}' in '{name}'")
    task = "segment" if (m.group(3) or "seg" in base.lower()) else "detect"
    return version, m.group(2).lower(), task


class YOLO:
    """Drop-in predictor for the reference's ``YOLO(weights)`` usage.

    weights: a model name ('yolo10s-seg'), an ultralytics ``.pt`` / state-dict
    ``.pth`` path, or a ``.msgpack`` file of the JAX package's flax variables.
    A name or a missing file gives a seeded random init.
    dtype: the model's compute type, ``torch.float32`` or ``torch.bfloat16``.
    int8_serving: int8 convolutions (module docstring); validate the accuracy on
    the weights you serve before use.
    device: ``None`` (the card) or ``"cpu"``; without a card only ``"cpu"`` works.
    """

    def __init__(
        self,
        weights: str = "yolo10s-seg",
        nc: int = 1,
        names: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        max_det: int = 300,
        max_masks: int = 32,
        seed: int = 0,
        int8_serving: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.weights_path = str(weights)
        self.version, self.scale, self.task = parse_model_name(self.weights_path)
        self.nc = nc
        self.names = names or {i: f"class{i}" for i in range(nc)}
        self.max_det = max_det
        self.max_masks = max_masks
        self.int8_serving = bool(int8_serving)
        self._act_scales: Optional[dict] = None      # static int8 activation scales (calibrate_int8)
        # Platt calibration (a, b): reported conf = σ(a·logit(s) + b)
        self.conf_calib: Optional[Tuple[float, float]] = None
        # int8 weights are quantised from fp32 ones (nn/quant.py): built in fp32, frozen, then cast
        self.model = YOLOModel(self.version, self.scale, nc, self.task,
                               dtype=torch.float32 if self.int8_serving else dtype)
        self._load_weights(seed)
        if self.int8_serving:
            freeze_int8_weights(self.model)
            self.model.cast(dtype)
        self.model.to(self.device).eval()

    def _load_weights(self, seed: int) -> None:
        path = self.weights_path
        if os.path.exists(path):
            if path.endswith((".pt", ".pth")):
                load_yolo_state_dict(self.model, extract_state_dict(path))
                return
            if path.endswith(".msgpack"):  # the JAX package's flax variables
                load_yolo_state_dict(self.model, export_yolo_state_dict(read_msgpack(path)))
                return
        self.model.reset_parameters(torch.Generator().manual_seed(seed))

    def to(self, device) -> "YOLO":
        self.device = resolve_device(device)
        self.model.to(self.device)
        return self

    def calibrate_int8(self, frames, imgsz: int = 640, percentile: float = 99.9) -> dict:
        """Static scales for the int8 path: the ``percentile`` of each eligible
        convolution's input over ``frames`` (any source ``predict`` takes, a
        video file too), each frame letterboxed as ``predict`` does and run
        alone.  The scales are kept on the predictor, which uses them from its
        next ``predict``, and returned."""
        frames_list, _ = self._to_frames(frames)
        if not frames_list:
            raise ValueError("calibrate_int8 needs at least one frame")
        batches = (letterbox(torch.from_numpy(f[None]).to(self.device), imgsz, bgr_to_rgb=True,
                             dtype=self.model.dtype)[0] for f in frames_list)
        self._act_scales = collect_act_scales(self.model, batches, percentile=percentile)
        return self._act_scales

    # -- confidence calibration ---------------------------------------------

    def load_calibration(self, src) -> Optional[Tuple[float, float]]:
        """Install Platt calibration from (a, b), a dict, a calibration.json path,
        or a checkpoint directory holding one.  Returns the installed pair (a
        missing sidecar leaves the current one, raw scores if none)."""
        if src is None:
            self.conf_calib = None
        elif isinstance(src, (tuple, list)):
            self.conf_calib = (float(src[0]), float(src[1]))
        elif isinstance(src, dict):
            self.conf_calib = (float(src["a"]), float(src["b"]))
        else:
            p = os.path.join(src, "calibration.json") if os.path.isdir(src) else str(src)
            if not os.path.exists(p):
                return self.conf_calib
            with open(p) as f:
                d = json.load(f)
            self.conf_calib = (float(d["a"]), float(d["b"]))
        return self.conf_calib

    @staticmethod
    def _calib_to_raw(conf_user: float, calib: Tuple[float, float]) -> float:
        """User-facing (calibrated) threshold → raw-score threshold."""
        a, b = calib
        p = min(max(float(conf_user), 1e-6), 1.0 - 1e-6)
        z = (math.log(p / (1.0 - p)) - b) / a
        return 1.0 / (1.0 + math.exp(-z))

    # -- source normalisation -----------------------------------------------

    @staticmethod
    def _to_frames(source) -> Tuple[List[np.ndarray], List[str]]:
        """Normalise source(s) to BGR uint8 HWC frames (ultralytics convention)."""

        def to_u8(arr):
            """Float sources with max <= 1 are read as normalised [0, 1] frames and
            scaled by 255; float sources above 1 as 0-255.  Pass uint8 to avoid
            the ambiguity for near-black 0-255 frames."""
            if arr.dtype == np.uint8:
                return arr
            a = arr.astype(np.float32)
            if np.issubdtype(arr.dtype, np.floating) and (a.size == 0 or a.max() <= 1.0):
                a = a * 255.0
            return np.clip(np.rint(a), 0, 255).astype(np.uint8)

        def one(s):
            if isinstance(s, str):
                if s.lower().endswith(".png") and os.path.isfile(s):
                    with open(s, "rb") as f:
                        img = decode_png(f.read())    # cv2.imread's pixels, without cv2
                    if img is not None:
                        return img, s
                import cv2

                img = cv2.imread(s)
                if img is None:
                    raise FileNotFoundError(s)
                return img, s
            if hasattr(s, "convert"):  # PIL → RGB → BGR
                return np.asarray(s.convert("RGB"))[..., ::-1].copy(), ""
            arr = np.asarray(s)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            return to_u8(arr), ""

        if isinstance(source, str) and os.path.isdir(source):
            names = sorted(
                f for f in os.listdir(source)
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp"))
            )
            pairs = [one(os.path.join(source, f)) for f in names]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        if isinstance(source, str) and source.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
            import cv2

            cap = cv2.VideoCapture(source)
            if not cap.isOpened():
                raise FileNotFoundError(source)
            frames = []
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    frames.append(frame)
            finally:
                cap.release()
            return frames, [source] * len(frames)
        if isinstance(source, (list, tuple)):
            if not source:
                return [], []
            frames, paths = zip(*[one(s) for s in source])
            return list(frames), list(paths)
        if isinstance(source, np.ndarray) and source.ndim == 4:
            return list(to_u8(source)), [""] * len(source)
        f, p = one(source)
        return [f], [p]

    # -- public API ---------------------------------------------------------

    def predict(self, source=None, conf: float = 0.25, iou: float = 0.7,
                imgsz: Optional[int] = None, retina_masks: bool = False, device=None,
                verbose: bool = False, **kwargs) -> List[Results]:
        imgsz = 640 if imgsz is None else int(imgsz)
        if device is not None:
            self.to(device)
        frames, paths = self._to_frames(source)
        results: List[Results] = []
        i = 0
        while i < len(frames):  # consecutive same-shape frames form one device batch
            j = i
            while j < len(frames) and frames[j].shape == frames[i].shape:
                j += 1
            results.extend(
                self._predict_batch(np.stack(frames[i:j]), paths[i:j], conf, iou, imgsz, retina_masks)
            )
            i = j
        return results

    __call__ = predict

    def _paste(self, masks_p, boxes_orig, r, pad, orig_hw, retina: bool):
        """Proto-resolution masks → original-frame uint8 {0, 1}.

        One linear resample from proto to original resolution with the
        letterbox pad carried as a fractional pad/4; retina then crops at
        original coordinates (non-retina masks arrive box-cropped at proto
        resolution).  bf16 masks are resampled and cropped in bf16."""
        pad4 = (pad[0] / 4.0, pad[1] / 4.0)
        full = paste_masks_to_original(masks_p, r / 4, pad4, orig_hw)
        if retina:
            full = crop_masks(full, boxes_orig)
        return (full > 0.5).to(torch.uint8)

    @torch.no_grad()
    def _run(self, frames: torch.Tensor, conf: float, iou: float, imgsz: int, retina: bool):
        """The device part of one batch: frames (B, h0, w0, 3) uint8 BGR."""
        h0, w0 = frames.shape[1:3]
        r, _, pad = letterbox_params(h0, w0, imgsz)
        imgs, _, _ = letterbox(frames, imgsz, bgr_to_rgb=True, dtype=self.model.dtype)
        with int8_convs(self.int8_serving, act_scales=self._act_scales if self.int8_serving else None):
            out = self.model(imgs)
        det = select_detections(out, nms_free=self.version == "v10", conf_thres=conf,
                                iou_thres=iou, max_det=self.max_det)
        valid = det["valid"]
        scores = det["scores"]
        if self.conf_calib is not None:
            a, b = self.conf_calib
            s = scores.clamp(1e-6, 1.0 - 1e-6)
            scores = torch.sigmoid(a * torch.log(s / (1.0 - s)) + b) * valid
        res = {
            "scores": scores,
            "classes": det["classes"],
            "count": det["count"],
            "boxes": scale_boxes(det["boxes"], r, pad, (h0, w0)) * valid[..., None],
        }
        if self.task == "segment":
            mm = self.max_masks
            masks_lb = decode_masks(out["proto"], det["coeffs"][:, :mm], det["boxes"][:, :mm],
                                    (imgsz, imgsz), upsample=False, threshold=None, crop=not retina)
            res["masks"] = self._paste(masks_lb, res["boxes"][:, :mm], r, pad, (h0, w0), retina)
            # kept on the device for frames with more than max_masks detections
            res["proto"], res["coeffs"], res["boxes_lb"] = out["proto"], det["coeffs"], det["boxes"]
        return res

    @torch.no_grad()
    def _overflow(self, proto_b, coeffs_all, boxes_all, start: int, imgsz: int,
                  orig_hw: Tuple[int, int], retina: bool):
        """Masks for detections [start, start + max_masks) of ONE frame."""
        mm = self.max_masks
        r, _, pad = letterbox_params(*orig_hw, imgsz)
        cc = torch.nn.functional.pad(coeffs_all, (0, 0, 0, mm))[start:start + mm]
        bb = torch.nn.functional.pad(boxes_all, (0, 0, 0, mm))[start:start + mm]
        masks_lb = decode_masks(proto_b[None], cc[None], bb[None], (imgsz, imgsz),
                                upsample=False, threshold=None, crop=not retina)
        bb_orig = scale_boxes(bb[None], r, pad, orig_hw)
        return self._paste(masks_lb, bb_orig, r, pad, orig_hw, retina)[0]

    def _predict_batch(self, batch: np.ndarray, paths, conf, iou, imgsz, retina):
        B, h0, w0, _ = batch.shape
        if self.conf_calib is not None:
            conf = self._calib_to_raw(conf, self.conf_calib)
        dev = self._run(torch.from_numpy(batch).to(self.device), conf, iou, imgsz, retina)
        host = {k: dev[k].cpu().numpy() for k in ("scores", "classes", "count", "boxes", "masks")
                if k in dev}
        results = []
        for b in range(B):
            n = int(host["count"][b])
            boxes = Boxes(host["boxes"][b][:n], host["scores"][b][:n], host["classes"][b][:n], (h0, w0))
            masks = None
            if "masks" in host:
                parts = [host["masks"][b][: min(n, self.max_masks)]]
                for start in range(self.max_masks, n, self.max_masks):
                    chunk = self._overflow(dev["proto"][b], dev["coeffs"][b], dev["boxes_lb"][b],
                                           start, imgsz, (h0, w0), retina)
                    parts.append(chunk[: n - start].cpu().numpy())
                masks = Masks(np.concatenate(parts, axis=0), (h0, w0))
            results.append(Results(batch[b], boxes, masks, names=self.names, path=paths[b]))
        return results
