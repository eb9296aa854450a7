"""The batch needle-speed CLI: the port's ``apps/auto_speed_calc.py``.

    python -m yolo_puncture_tpu_torch.apps.auto_speed_calc -p VIDEO_OR_DIR [-ym YOLO] [-cm CLS] [-yct CONF] [-jw WND]

The JAX app's flags and output: a ``Processing video: <path>`` line per video,
then ``{video}:  {start}-{end}  {speed:.2f}mm/s`` (or ``n/a``) per video.  The
detector and the EfficientNet-B3 classifier are built in bf16; a calibration
sidecar beside the detector's weights (``calibration.json``) makes ``-yct``
read calibrated.  Videos of one resolution share the device batches
(``VideoSpeedPipeline.process_videos``).  ``main(argv, device=None)`` runs on
the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os

import torch


def build_pipeline(yolo_model: str, classify_model: str, device_batch: int, imgsz: int, device=None):
    """The app's pipeline: the bf16 detector with its calibration sidecar and the
    bf16 B3 (from ``classify_model`` where that file exists, else a seeded init)."""
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    det = YOLO(yolo_model, nc=1, dtype=torch.bfloat16, device=device)
    det.load_calibration(os.path.dirname(yolo_model) or ".")
    cls = ClassifierNet("efficientnet_b3", checkpoint=classify_model if os.path.exists(classify_model) else None,
                        dtype=torch.bfloat16, device=device)
    return VideoSpeedPipeline(det, cls, device_batch=device_batch, imgsz=imgsz)


def list_videos(path: str):
    """A directory's ``.mp4`` files in name order, or the one file given."""
    if os.path.isdir(path):
        return [os.path.join(path, v) for v in sorted(os.listdir(path)) if v.endswith(".mp4")]
    return [path]


def speed_line(video: str, info) -> str:
    speed = f"{info.speed_mm_s:.2f}mm/s" if info.speed_mm_s else "n/a"
    return f"{video}:  {info.start_frame}-{info.end_frame}  {speed}"


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", type=str, required=True, help="Path to video directory or file")
    parser.add_argument("-ym", "--yolo_model", type=str, default="seg/yolo11n-seg-finetune.pt",
                        help="Path to YOLO model, e.g. seg/yolo11n-seg-finetune.pt")
    parser.add_argument("-cm", "--classify_model", type=str, default="EfficientNet/efficientnet_b3.pth.tar",
                        help="Path to classification model")
    parser.add_argument("-yct", "--yolo_conf_threshold", type=float, default=0.35,
                        help="YOLO confidence threshold, default is 0.35")
    parser.add_argument("-jw", "--judge_wnd", type=int, default=20,
                        help="Window size for judging inserted needle, default is 20")
    parser.add_argument("--batch", type=int, default=16, help="device frame batch")
    parser.add_argument("--imgsz", type=int, default=640)
    args = parser.parse_args(argv)

    pipe = build_pipeline(args.yolo_model, args.classify_model, args.batch, args.imgsz, device=device)
    videos = list_videos(args.path)
    for video_path in videos:
        print(f"Processing video: {video_path}")
    video_info = pipe.process_videos(videos, conf=args.yolo_conf_threshold, judge_wnd=args.judge_wnd)
    for video, info in video_info.items():
        print(speed_line(video, info))
    return video_info


if __name__ == "__main__":
    main()
