"""Speed accuracy against hand-labelled key frames: the port's
``apps/evaluate_speed.py``.

    python -m yolo_puncture_tpu_torch.apps.evaluate_speed -p VIDEO_OR_DIR [flags]

Runs the speed pipeline over ``video{N}.mp4`` files, compares the predicted key
frames and speed with ``KEY_FRAME[N]`` (or ``--key_frames``), and prints for
each video ``{name}: pred {start}-{end} vs actual {act} | dev raw=… gauss=…
savgol=…``, then the ``Avg - …`` line of the means.  ``--det_init`` /
``--cls_init`` load flax msgpack variables over the built detector and
classifier (``utils/convert.py read_msgpack``); ``--cls_model`` /
``--crop_size`` build an fp32 pipeline with another classifier or crop size.
``main(argv, device=None)`` runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import re

# the hand-labelled [insert_start, insert_end] frames of the 19 evaluation videos
# (a copy of the repository's tools/toolbox.py KEY_FRAME)
KEY_FRAME = {
    1: [122, 165],
    2: [44, 94],
    3: [0, 23],
    4: [73, 113],
    5: [27, 49],
    6: [25, 64],
    7: [14, 61],
    8: [141, 180],
    9: [12, 27],
    10: [7, 29],
    11: [3, 19],
    12: [9, 34],
    13: [9, 25],
    14: [29, 57],
    15: [30, 56],
    16: [62, 81],
    17: [151, 165],
    18: [111, 128],
    19: [60, 92],
}


def main(argv=None, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", required=True, help="video dir or file")
    parser.add_argument("-ym", "--yolo_model", default="seg/yolo11n-seg-finetune.pt")
    parser.add_argument("-cm", "--classify_model", default="EfficientNet/efficientnet_b3.pth.tar")
    parser.add_argument("-yct", "--yolo_conf_threshold", type=float, default=0.35)
    parser.add_argument("-jw", "--judge_wnd", type=int, default=20)
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--key_frames", default=None,
                        help="JSON file {video_no: [start, end]} overriding the built-in KEY_FRAME ground truth")
    parser.add_argument("--det_init", default=None,
                        help="flax msgpack detector variables loaded over the built model")
    parser.add_argument("--cls_init", default=None, help="flax msgpack classifier variables")
    parser.add_argument("--cls_model", default=None,
                        help="classifier registry name override (e.g. efficientnet_b0 or van_b0 to match a --cls_init "
                             "checkpoint)")
    parser.add_argument("--crop_size", type=int, default=None, help="classifier crop size override")
    args = parser.parse_args(argv)

    from yolo_puncture_tpu_torch.analytics.stats import compute_metrics
    from yolo_puncture_tpu_torch.apps.auto_speed_calc import build_pipeline, list_videos
    from yolo_puncture_tpu_torch.pipeline.video import iter_video_frames
    from yolo_puncture_tpu_torch.utils.convert import (
        export_classifier_state_dict,
        export_yolo_state_dict,
        load_classifier_state_dict,
        load_yolo_state_dict,
        read_msgpack,
    )

    key_frame = KEY_FRAME
    if args.key_frames:
        with open(args.key_frames) as f:
            key_frame = {int(k): tuple(v) for k, v in json.load(f).items()}

    if args.cls_model or args.crop_size:
        # another classifier or crop size: fp32 models, as the JAX app builds them here
        from yolo_puncture_tpu_torch import YOLO
        from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
        from yolo_puncture_tpu_torch.tasks import ClassifierNet

        det = YOLO(args.yolo_model, nc=1, device=device)
        cls = ClassifierNet(args.cls_model or "efficientnet_b3",
                            **({"input_size": args.crop_size} if args.crop_size else {}), device=device)
        pipe = VideoSpeedPipeline(det, cls, device_batch=args.batch, imgsz=args.imgsz,
                                  **({"crop_size": args.crop_size} if args.crop_size else {}))
    else:
        pipe = build_pipeline(args.yolo_model, args.classify_model, args.batch, args.imgsz, device=device)
    if args.det_init:
        load_yolo_state_dict(pipe.detector.model, export_yolo_state_dict(read_msgpack(args.det_init)))
    if args.cls_init:
        load_classifier_state_dict(pipe.classifier.model, export_classifier_state_dict(read_msgpack(args.cls_init)))

    deviations = {}
    for vp in list_videos(args.path):
        name = os.path.splitext(os.path.basename(vp))[0]
        m = re.search(r"video(\d+)", name)
        if not m or int(m.group(1)) not in key_frame:
            print(f"{name}: no ground truth, skipping")
            continue
        act = tuple(key_frame[int(m.group(1))])
        fps, _, _, frames = iter_video_frames(vp)
        out = pipe.process_frames(frames, fps, conf=args.yolo_conf_threshold, judge_wnd=args.judge_wnd)
        if out.start_frame is None:
            print(f"{name}: pipeline produced no key frame")
            continue
        try:
            devs = compute_metrics(out.lens, (out.start_frame, out.end_frame or out.start_frame + 1), act, fps)
        except ZeroDivisionError:
            print(f"{name}: degenerate lens; skipping")
            continue
        deviations[name] = devs
        print(f"{name}: pred {out.start_frame}-{out.end_frame} vs actual {act} "
              f"| dev raw={devs[0]:.2f} gauss={devs[1]:.2f} savgol={devs[2]:.2f}")

    if deviations:
        avgs = [sum(v) / len(deviations) for v in zip(*deviations.values())]
        print(f"Avg - Normal: {avgs[0]:.2f}, Gaussian: {avgs[1]:.2f}, Savitzky Golay: {avgs[2]:.2f}")
    return deviations


if __name__ == "__main__":
    main()
