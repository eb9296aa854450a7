"""Batched video speed pipeline: the needle's length per frame, the insertion
state, the key frame and the insertion speed.

Counterpart of ``yolo_puncture_tpu/pipeline/runner.py``.  Per batch of
``device_batch`` frames, on the detector's device, one function under
``torch.no_grad`` runs:

  letterbox (+ BGR→RGB) → YOLOModel → top-k / NMS (max_det 8) → the best slot:
  its box scaled to the original frame, its mask decoded at letterbox
  resolution (``decode_masks``: the CUDA kernel ``proto_decode`` at proto
  resolution, then upsample, crop and threshold) → crop_size² crops of the
  original frames around the box (``utils/transform.py crop_frame`` semantics)
  → classifier → fp32 softmax.

The host then runs, per video: the fallback chain (a frame without a detection
takes the last box and the last length), the largest contour of each mask →
original coordinates → ``min_rect_len``, the classifier again on crops around
the fallback boxes of undetected frames, the key frame and the class repair,
Gaussian smoothing and the insertion state machine.

Batch i is launched before batch i-1's results are read.  On the card the
frames go up from pinned host memory and each batch's results come back into
pinned host buffers, copies queued right behind the batch's own work with an
event recorded after them, so reading batch i-1 waits for batch i-1 and not
for batch i.  PyTorch runs eagerly: there is no compiled step per geometry, and
a short last batch is not padded (eval-mode BatchNorm treats each frame alone).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.analytics.keyframe import find_insert_start, fix_class_prob
from yolo_puncture_tpu_torch.analytics.speed import SpeedResult, insertion_state_machine
from yolo_puncture_tpu_torch.ops.geometry import mask_to_polygons, min_rect_len
from yolo_puncture_tpu_torch.ops.letterbox import letterbox, scale_boxes
from yolo_puncture_tpu_torch.ops.masks import decode_masks
from yolo_puncture_tpu_torch.ops.nms import select_detections
from yolo_puncture_tpu_torch.ops.signal import gaussian_smoothing
from yolo_puncture_tpu_torch.predict.predictor import YOLO
from yolo_puncture_tpu_torch.utils.profiling import StageTimer
from yolo_puncture_tpu_torch.utils.transform import crop_frames_batch


@dataclasses.dataclass
class PipelineOutput:
    start_frame: Optional[int]
    end_frame: Optional[int]
    speed_mm_s: Optional[float]
    lens: List[float]              # per-frame min-rect pixel length (original coordinates)
    smooth_lens: List[float]       # Gaussian-smoothed lens (the series the state machine saw)
    actual_lens: List[float]       # calibrated mm lengths (NaN before calibration)
    classes: List[int]
    probs: List[float]
    boxes: List[Tuple[int, int, int, int]]
    detected: List[bool]
    fps: float


def _round_robin(iters: Sequence[Iterator]) -> Iterator[Tuple[int, np.ndarray]]:
    """(video index, frame): one frame of each live video in turn until all are done."""
    live = list(enumerate(iters))
    while live:
        still = []
        for i, it in live:
            try:
                frame = next(it)
            except StopIteration:
                continue
            yield i, frame
            still.append((i, it))
        live = still


class VideoSpeedPipeline:
    """End-to-end needle-speed analysis over batches of frames.

    The detector and the classifier must be on one device; the pipeline runs
    there (the card unless both were built with ``device="cpu"``)."""

    def __init__(
        self,
        detector: YOLO,
        classifier=None,
        device_batch: int = 8,
        imgsz: int = 640,
        crop_size: int = 380,
    ):
        if classifier is not None and classifier.device != detector.device:
            raise ValueError(
                f"the detector is on {detector.device} and the classifier on {classifier.device}: "
                "the pipeline runs both on one device"
            )
        self.detector = detector
        self.classifier = classifier
        self.device_batch = device_batch
        self.imgsz = imgsz
        self.crop_size = crop_size
        self.timer = StageTimer()

    # -- the device step ------------------------------------------------------

    def _crops(self, frames: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
        """crop_size² RGB crops of the original BGR frames (B, h0, w0, 3) around
        each box centre, with ``crop_frame``'s semantics: the centre truncated to
        int, the window clamped to the frame, what falls outside zero at the
        bottom and right."""
        B, h0, w0, _ = frames.shape
        crop, half = self.crop_size, self.crop_size // 2
        cx = ((box[:, 0] + box[:, 2]) / 2).to(torch.int64)
        cy = ((box[:, 1] + box[:, 3]) / 2).to(torch.int64)
        x1, y1 = (cx - half).clamp(min=0), (cy - half).clamp(min=0)
        wv = ((cx + half).clamp(max=w0) - x1).clamp(min=0)
        hv = ((cy + half).clamp(max=h0) - y1).clamp(min=0)
        ar = torch.arange(crop, device=frames.device)
        rows = (y1[:, None] + ar).clamp(max=h0 - 1)[:, :, None]
        cols = (x1[:, None] + ar).clamp(max=w0 - 1)[:, None, :]
        inside = (ar[None, :, None] < hv[:, None, None]) & (ar[None, None, :] < wv[:, None, None])
        c = frames[torch.arange(B, device=frames.device)[:, None, None], rows, cols].flip(-1)
        return torch.where(inside[..., None], c, torch.zeros_like(c))

    @torch.no_grad()
    def _step(self, frames: torch.Tensor, conf: float):
        """One batch on the device: BGR uint8 (B, h0, w0, 3) → ({name: (B, …)
        tensor or None}, ratio, (pad_left, pad_top))."""
        h0, w0 = frames.shape[1:3]
        det = self.detector
        imgs, r, pad = letterbox(frames, self.imgsz, bgr_to_rgb=True)
        out = det.model(imgs)
        sel = select_detections(out, nms_free=det.version == "v10", conf_thres=conf, iou_thres=0.7, max_det=8)
        # slot 0 holds the best score: the reference's argmax over the detections
        box = scale_boxes(sel["boxes"][:, 0], r, pad, (h0, w0))
        res = {"valid": sel["valid"][:, 0], "conf": sel["scores"][:, 0], "box": box, "mask_lb": None}
        if "coeffs" in sel:
            m = decode_masks(out["proto"], sel["coeffs"][:, :1], sel["boxes"][:, :1],
                             (self.imgsz, self.imgsz), upsample=True, threshold=0.5)
            res["mask_lb"] = m[:, 0].to(torch.uint8)
        if self.classifier is not None:
            idx, p, _ = self.classifier._forward(self._crops(frames, box))
            res["cls"], res["cls_prob"] = idx, p
        return res, r, pad

    def _submit(self, items: List[Tuple[int, np.ndarray]], conf: float):
        """Upload and launch one batch of (video index, frame); queue the copies
        of its results to the host.  Returns what ``_fetch`` needs."""
        frames = [f for _, f in items]
        with self.timer.stage("device_submit"):
            dev = self.detector.device
            if dev.type == "cuda":
                staged = torch.empty((len(frames), *frames[0].shape), dtype=torch.uint8, pin_memory=True)
                np.stack(frames, out=staged.numpy())
                out, r, pad = self._step(staged.to(dev, non_blocking=True), conf)
                host = {}
                for k, v in out.items():
                    if v is not None:
                        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        host[k].copy_(v, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            else:
                done = None
                out, r, pad = self._step(torch.from_numpy(np.stack(frames)), conf)
                host = {k: v for k, v in out.items() if v is not None}
        return host, done, items, r, pad

    def _fetch(self, inflight, raws, undetected) -> None:
        """Wait for a submitted batch and append one raw record per frame to its video."""
        host, done, items, r, pad = inflight
        with self.timer.stage("device_fetch"):
            if done is not None:
                done.synchronize()
            out = {k: v.numpy() for k, v in host.items()}
        for i, (vid, frame) in enumerate(items):
            rec = {k: out[k][i] if k in out else None for k in ("valid", "conf", "box", "mask_lb", "cls", "cls_prob")}
            rec["ratio"] = np.float32(r)
            rec["pad"] = np.array(pad, np.float32)
            raws[vid].append(rec)
            if not bool(rec["valid"]):
                # the classifier must see the crop around the FALLBACK box, known
                # only in the host pass: keep the frame and classify it there
                undetected[vid][len(raws[vid]) - 1] = frame.copy()

    def _run(self, tagged: Iterable[Tuple[int, np.ndarray]], n_videos: int, conf: float):
        """The device loop over (video index, BGR frame) in batches of
        ``device_batch``: batch i is launched before batch i-1 is read.  Returns
        per video its raw records and its undetected frames {index: frame}, and
        the (h, w) of the last batch's frames (None without frames)."""
        if getattr(self.detector, "conf_calib", None) is not None:
            # with a calibration, ``conf`` is on the calibrated scale: map it to the raw score
            conf = self.detector._calib_to_raw(conf, self.detector.conf_calib)
        raws: List[List[Dict]] = [[] for _ in range(n_videos)]
        undetected: List[Dict[int, np.ndarray]] = [{} for _ in range(n_videos)]
        tagged, inflight, orig_hw = iter(tagged), None, None
        while batch := list(itertools.islice(tagged, self.device_batch)):
            orig_hw = batch[0][1].shape[:2]
            submitted = self._submit(batch, conf)
            if inflight is not None:
                self._fetch(inflight, raws, undetected)
            inflight = submitted
        if inflight is not None:
            self._fetch(inflight, raws, undetected)
        return raws, undetected, orig_hw

    # -- entry points -----------------------------------------------------------

    def process_frames(self, frames: Iterable[np.ndarray], fps: float, conf: float = 0.35,
                       judge_wnd: int = 20) -> PipelineOutput:
        """Run the full analysis over BGR uint8 frames of one video."""
        raws, undetected, orig_hw = self._run(((0, f) for f in frames), 1, conf)
        return self._host_pass(raws[0], undetected[0], orig_hw, fps, judge_wnd)

    def _host_pass(self, raw: List[Dict], undetected_frames: Dict[int, np.ndarray], orig_hw,
                   fps: float, judge_wnd: int) -> PipelineOutput:
        n = len(raw)
        if n == 0:
            return PipelineOutput(None, None, None, [], [], [], [], [], [], [], fps)

        # the fallback chain: a frame without a detection takes the last box and length
        with self.timer.stage("host_geometry"):
            lens: List[float] = []
            boxes: List[Tuple[int, int, int, int]] = []
            detected: List[bool] = []
            last_box = None
            last_len = 0.0
            r = float(raw[0]["ratio"])
            h0, w0 = orig_hw
            for item in raw:
                if bool(item["valid"]):
                    box = tuple(int(v) for v in item["box"])
                    last_box = box
                    poly = mask_to_polygons(item["mask_lb"], largest_only=True)
                    if len(poly):
                        poly = (poly - np.asarray(item["pad"], np.float32)) / r  # letterbox → original
                        length, _ = min_rect_len(poly)
                    else:
                        length = 0.0
                    last_len = length
                    lens.append(length)
                    boxes.append(box)
                    detected.append(True)
                else:
                    boxes.append(last_box if last_box is not None else (0, 0, w0, h0))
                    lens.append(last_len)
                    detected.append(False)

        if self.classifier is not None:
            classes = [int(item["cls"]) for item in raw]
            probs = [float(item["cls_prob"]) for item in raw]
            if undetected_frames:
                with self.timer.stage("host_classify"):
                    idxs = sorted(undetected_frames)
                    crops = crop_frames_batch([undetected_frames[i] for i in idxs],
                                              np.asarray([boxes[i] for i in idxs]),
                                              self.classifier.input_size)[..., ::-1]
                    c_idx, c_p = self.classifier.predict(crops)
                    for j, i in enumerate(idxs):
                        classes[i] = int(c_idx[j])
                        probs[i] = float(c_p[j])
        else:
            classes = [0] * n
            probs = [0.0] * n

        with self.timer.stage("analytics"):
            if self.classifier is not None:
                insert_start = find_insert_start(classes, probs, judge_wnd)
                classes, probs = fix_class_prob(classes, probs, insert_start)
            else:
                insert_start = 0
            smooth = gaussian_smoothing(lens)
            res: SpeedResult = insertion_state_machine(classes, smooth, detected, insert_start, fps)
        return PipelineOutput(
            start_frame=res.start_frame,
            end_frame=res.end_frame,
            speed_mm_s=res.speed_mm_s,
            lens=lens,
            smooth_lens=[float(v) for v in smooth],
            actual_lens=[float(v) for v in res.actual_lens],
            classes=classes,
            probs=probs,
            boxes=boxes,
            detected=detected,
            fps=fps,
        )

    def process_video(self, video_path: str, conf: float = 0.35, judge_wnd: int = 20) -> PipelineOutput:
        from yolo_puncture_tpu_torch.pipeline.video import iter_video_frames

        fps, _, _, frames = iter_video_frames(video_path)
        return self.process_frames(frames, fps, conf=conf, judge_wnd=judge_wnd)

    def process_videos(self, video_paths, conf: float = 0.35, judge_wnd: int = 20,
                       interleave: bool = True) -> Dict[str, PipelineOutput]:
        """Several videos at once: {file name without extension: PipelineOutput}.

        With ``interleave`` and videos of one resolution, one frame of each live
        video in turn fills the shared device batches and the records go back to
        their videos for the host pass; mixed resolutions run one video after
        the other."""
        from yolo_puncture_tpu_torch.pipeline.video import iter_video_frames

        streams = []
        for p in video_paths:
            fps, w, h, frames = iter_video_frames(p)
            streams.append((os.path.splitext(os.path.basename(p))[0], fps, (h, w), frames))
        return self._process_streams(streams, conf, judge_wnd, interleave)

    def _process_streams(self, streams, conf: float, judge_wnd: int, interleave: bool = True):
        """``process_videos`` after decoding: ``streams`` holds (name, fps,
        (h, w), iterator of BGR frames) per video."""
        if not (interleave and len(streams) > 1 and len({s[2] for s in streams}) == 1):
            return {name: self.process_frames(frames, fps, conf, judge_wnd) for name, fps, _, frames in streams}
        raws, undetected, _ = self._run(_round_robin([iter(s[3]) for s in streams]), len(streams), conf)
        return {name: self._host_pass(raws[i], undetected[i], hw, fps, judge_wnd)
                for i, (name, fps, hw, _) in enumerate(streams)}
