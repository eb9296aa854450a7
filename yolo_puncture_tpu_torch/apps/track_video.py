"""YOLO as the detector of the mask tracker: the port's ``apps/track_video.py``.

    python -m yolo_puncture_tpu_torch.apps.track_video --video_name v --img_path DIR_OR_VIDEO [flags]

The same flags, ``Configuration:`` line and outputs as the repository's
``apps/track_video.py``: frames from a video or a directory of images
(``pipeline/video.py VideoReader``), every frame scheduled online (a detection
every ``--detection_every`` frames, propagation between) or semi-online (the
detections of ``--num_voting_frames`` frames voted on before they enter the
tracker), one id-mask PNG per frame under ``<output>/Annotations/<video>/`` and
``<output>/pred.json``.  ``--amp`` builds the detector and the tracker in bf16;
``--batch_propagation`` sends runs of propagation-only frames through
``TrackerCore.step_batch``; ``--align_voting`` aligns the buffered detections to
the keyframe before voting (``affinity`` or ``propagate``).

Where the JAX app calls cv2 on frames, the port takes cv2's arithmetic without
cv2 (``ops/resize.py``): the detector's input is the frame with its shorter side
resized to ``--size`` (INTER_LINEAR on uint8), and each float retina mask goes
back to the frame's size with INTER_LINEAR on float32 (``resize_linear_f32``).
``main(argv, device=None)`` runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
from os import path

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.resize import resize_linear_f32, resize_linear_u8
from yolo_puncture_tpu_torch.track import (
    FrameInfo,
    ObjectInfo,
    ResultSaver,
    TrackerCore,
    flush_buffer,
    get_input_frame_for_deva,
    reference_tracker_geometry,
)


def auto_segment(config, image_np, yolo_model, min_side, suppress_small_mask):
    """YOLO instance segmentation of an RGB frame → (id mask (h, w) int64,
    segments_info).  The detector sees the frame with its shorter side at
    ``min_side``, at the reference's operating point (``conf=0.9``, retina
    masks); each mask is resized back to the frame, masks under
    ``MIN_AREA_THRESHOLD`` are dropped when ``suppress_small_mask``, and a mask
    contained (> ``dedup_overlap``) in an earlier kept one is a duplicate."""
    h, w = image_np.shape[:2]
    if min_side > 0:
        scale = min_side / min(h, w)
        image_np = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(image_np)),
                                    (int(h * scale), int(w * scale))).numpy()

    results = yolo_model.predict(image_np[..., ::-1], retina_masks=True, conf=0.9,
                                 imgsz=config.get("det_imgsz", 640))
    det = results[0]
    output_mask = np.zeros((h, w), np.int64)
    segments_info = []
    curr_id = 1
    dedup = float(config.get("dedup_overlap", 0.6))
    kept_masks = []
    if det.masks is not None:
        for i in range(len(det.masks)):
            mask = det.masks.data[i]
            if mask.shape != (h, w):
                mask = resize_linear_f32(torch.from_numpy(np.ascontiguousarray(mask, np.float32)), (h, w)).numpy()
            if suppress_small_mask and mask.sum() < config.get("MIN_AREA_THRESHOLD", 100):
                continue
            mb = mask > 0.5
            area = mb.sum()
            if any((mb & k).sum() / max(min(area, k.sum()), 1) > dedup for k in kept_masks):
                continue
            kept_masks.append(mb)
            output_mask[mb] = curr_id
            segments_info.append(ObjectInfo(id=curr_id, score=float(det.boxes.conf[i]),
                                            category_id=int(det.boxes.cls[i])))
            curr_id += 1
    return output_mask, segments_info


def _vote_and_incorporate(tracker, result_saver, need_resize, hw, step_rest):
    """The semi-online voting step: vote over the buffer, incorporate the voted
    keyframe mask, save it, propagate the rest of the buffer through
    ``step_rest(frames)`` (one prob per frame), save those, clear the buffer."""
    cfg = tracker.config
    keyframe = tracker.frame_buffer[0]
    _, mask, new_segments_info = tracker.vote_in_temporary_buffer(keyframe_selection="first")
    prob = tracker.incorporate_detection(keyframe.image, mask, new_segments_info, incremental=True)
    tracker.next_voting_frame += cfg.get("detection_every", 5)
    result_saver.save_mask(prob, keyframe.name, need_resize=need_resize, shape=hw, image_np=keyframe.image_np)
    rest = tracker.frame_buffer[1:]
    if rest:
        for prob, fi in zip(step_rest([f.image for f in rest]), rest):
            result_saver.save_mask(prob, fi.name, need_resize, shape=hw, image_np=fi.image_np)
    tracker.clear_buffer()


def process_frame(tracker, yolo_model, frame_path, result_saver, ti, image_np=None):
    """One frame through the semi-online or online schedule."""
    if image_np is None:
        import cv2

        image_np = cv2.imread(frame_path)[..., ::-1]
    cfg = tracker.config
    h, w = image_np.shape[:2]
    new_min_side = cfg.get("size", 480)
    suppress_small_mask = cfg.get("suppress_small_objects", True)
    need_resize = new_min_side > 0
    image = get_input_frame_for_deva(image_np, new_min_side)
    frame_name = path.basename(frame_path)
    frame_info = FrameInfo(image, None, None, ti, {"frame": [frame_name], "shape": [h, w]})

    if cfg.get("temporal_setting", "semionline") == "semionline":
        if ti + cfg.get("num_voting_frames", 3) > tracker.next_voting_frame:
            mask, segments_info = auto_segment(cfg, image_np, yolo_model, new_min_side, suppress_small_mask)
            frame_info.mask = mask
            frame_info.segments_info = segments_info
            frame_info.image_np = image_np
            tracker.add_to_temporary_buffer(frame_info)
            if ti == tracker.next_voting_frame:
                _vote_and_incorporate(tracker, result_saver, need_resize, (h, w),
                                      lambda images: [tracker.step(im, None, None) for im in images])
        else:
            prob = tracker.step(image, None, None)
            result_saver.save_mask(prob, frame_name, need_resize=need_resize, shape=(h, w), image_np=image_np)
    else:  # online
        if ti % cfg.get("detection_every", 5) == 0:
            mask, segments_info = auto_segment(cfg, image_np, yolo_model, new_min_side, suppress_small_mask)
            prob = tracker.incorporate_detection(image, mask, segments_info, incremental=True)
        else:
            prob = tracker.step(image, None, None)
        result_saver.save_mask(prob, frame_name, need_resize=need_resize, shape=(h, w), image_np=image_np)


def process_video_batched(tracker, yolo_model, video_reader, result_saver):
    """``process_frame``'s schedule with the runs of propagation-only frames sent
    through ``TrackerCore.step_batch``; a pending run is flushed before any
    detection enters the tracker, so the memory sees the same order of
    operations.  ``video_reader`` yields (RGB frame, path) pairs."""
    cfg = tracker.config
    semionline = cfg.get("temporal_setting", "semionline") == "semionline"
    min_side = cfg.get("size", 480)
    suppress_small_mask = cfg.get("suppress_small_objects", True)
    need_resize = min_side > 0
    pending = []  # (image, frame_name, (h, w), image_np)

    def flush_pending():
        if not pending:
            return
        probs = tracker.step_batch([p[0] for p in pending])
        for prob, (_, name, shape, image_np) in zip(probs, pending):
            result_saver.save_mask(prob, name, need_resize=need_resize, shape=shape, image_np=image_np)
        pending.clear()

    for ti, (frame, im_path) in enumerate(video_reader):
        image_np = frame
        h, w = image_np.shape[:2]
        image = get_input_frame_for_deva(image_np, min_side)
        frame_name = path.basename(im_path)

        if semionline:
            if ti + cfg.get("num_voting_frames", 3) > tracker.next_voting_frame:
                flush_pending()
                mask, segments_info = auto_segment(cfg, image_np, yolo_model, min_side, suppress_small_mask)
                tracker.add_to_temporary_buffer(FrameInfo(image, mask, segments_info, ti,
                                                          {"frame": [frame_name], "shape": [h, w]},
                                                          image_np=image_np))
                if ti == tracker.next_voting_frame:
                    _vote_and_incorporate(tracker, result_saver, need_resize, (h, w), tracker.step_batch)
            else:
                pending.append((image, frame_name, (h, w), image_np))
        else:  # online
            if ti % cfg.get("detection_every", 5) == 0:
                flush_pending()
                mask, segments_info = auto_segment(cfg, image_np, yolo_model, min_side, suppress_small_mask)
                prob = tracker.incorporate_detection(image, mask, segments_info, incremental=True)
                result_saver.save_mask(prob, frame_name, need_resize=need_resize, shape=(h, w), image_np=image_np)
            else:
                pending.append((image, frame_name, (h, w), image_np))
    flush_pending()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_name", type=str, required=True)
    parser.add_argument("--img_path", type=str, required=True, help="video file or frame directory")
    parser.add_argument("--output", type=str, default="./track_out")
    parser.add_argument("--model", type=str, default="seg/yolo11n-seg-finetune.pt")
    parser.add_argument("--temporal_setting", type=str, default="semionline", choices=["semionline", "online"])
    parser.add_argument("--num_voting_frames", type=int, default=3)
    parser.add_argument("--detection_every", type=int, default=5)
    parser.add_argument("--size", type=int, default=480)
    parser.add_argument("--max_missed_detection_count", type=int, default=10)
    parser.add_argument("--max_mid_term_frames", type=int, default=10)
    parser.add_argument("--min_mid_term_frames", type=int, default=5)
    parser.add_argument("--num_prototypes", type=int, default=128)
    parser.add_argument("--max_long_term_elements", type=int, default=10000)
    parser.add_argument("--disable_long_term", action="store_true")
    parser.add_argument("--mem_every", type=int, default=5)
    parser.add_argument("--amp", action="store_true", help="bf16 compute")
    parser.add_argument("--imgsz", type=int, default=640, help="detector letterbox size")
    parser.add_argument("--tracker_weights", type=str, default=None,
                        help="msgpack propagation weights (apps/train_tracker.py)")
    parser.add_argument("--batch_propagation", action="store_true",
                        help="batch propagation-only frames through the windowed fast path (TrackerCore.step_batch)")
    parser.add_argument("--align_voting", nargs="?", const="affinity", default="off",
                        choices=["off", "affinity", "propagate"],
                        help="project buffered detections into keyframe coords before semionline voting: bare "
                        "flag/'affinity' = single-hop key-affinity correspondence; 'propagate' = backward "
                        "propagation through the buffer")
    return parser.parse_args(argv)


def make_config(args: argparse.Namespace, vid_length: int) -> dict:
    """The tracker's configuration, with the long-term switch of the reference:
    long-term memory counts usage only where the video is long enough to fill
    the long-term bank."""
    cfg = {
        "temporal_setting": args.temporal_setting,
        "num_voting_frames": args.num_voting_frames,
        "detection_every": args.detection_every,
        "size": args.size,
        "suppress_small_objects": True,
        "mem_every": args.mem_every,
        "enable_long_term": not args.disable_long_term,
        "max_mid_term_frames": args.max_mid_term_frames,
        "min_mid_term_frames": args.min_mid_term_frames,
        "num_prototypes": args.num_prototypes,
        "max_long_term_elements": args.max_long_term_elements,
        "max_missed_detection_count": args.max_missed_detection_count,
        "align_voting": False if args.align_voting == "off" else args.align_voting,
        "video_name": args.video_name,
        "det_imgsz": args.imgsz,
    }
    cfg["enable_long_term_count_usage"] = (
        cfg["enable_long_term"]
        and (vid_length / (cfg["max_mid_term_frames"] - cfg["min_mid_term_frames"]) * cfg["num_prototypes"])
        >= cfg["max_long_term_elements"]
    )
    return cfg


def build_models(args: argparse.Namespace, cfg: dict, frame_hw, device=None):
    """(detector, tracker) for frames of ``frame_hw``: ``YOLO(--model)`` in bf16
    with ``--amp``, with the calibration sidecar beside its weights (the
    hard-coded ``conf=0.9`` then reads calibrated), and ``TrackerCore`` at the
    reference geometry of the frame's size with ``--tracker_weights``."""
    from yolo_puncture_tpu_torch import YOLO

    dtype = torch.bfloat16 if args.amp else torch.float32
    yolo_model = YOLO(args.model, nc=1, dtype=dtype, device=device)
    yolo_model.load_calibration(os.path.dirname(args.model) or ".")
    th, tw = reference_tracker_geometry(frame_hw, args.size)
    tracker = TrackerCore(
        config=cfg,
        variables=args.tracker_weights if args.tracker_weights and os.path.exists(args.tracker_weights) else None,
        image_size=(max(th, 16), max(tw, 16)),
        dtype=dtype,
        device=device,
    )
    tracker.next_voting_frame = args.num_voting_frames - 1
    tracker.enabled_long_id()
    return yolo_model, tracker


def track(args: argparse.Namespace, tracker, yolo_model, frames, result_saver=None) -> ResultSaver:
    """Run the schedule over ``frames`` ((RGB frame, path) pairs), flush the
    buffer, write ``pred.json``; returns the saver (a ``ResultSaver`` under
    ``--output`` unless one is given)."""
    if result_saver is None:
        result_saver = ResultSaver(args.output, tracker.config["video_name"], dataset="demo",
                                   object_manager=tracker.object_manager)
    if args.batch_propagation:
        process_video_batched(tracker, yolo_model, frames, result_saver)
    else:
        for ti, (frame, im_path) in enumerate(frames):
            process_frame(tracker, yolo_model, im_path, result_saver, ti, image_np=frame)
    flush_buffer(tracker, result_saver)
    result_saver.end()
    os.makedirs(args.output, exist_ok=True)
    with open(path.join(args.output, "pred.json"), "w") as f:
        json.dump(result_saver.video_json, f, indent=4)
    return result_saver


def main(argv=None, device=None):
    from yolo_puncture_tpu_torch.pipeline.video import VideoReader

    args = parse_args(argv)
    video_reader = VideoReader(args.img_path)
    cfg = make_config(args, len(video_reader))
    print("Configuration:", cfg)
    yolo_model, tracker = build_models(args, cfg, video_reader[0][0].shape[:2], device)
    track(args, tracker, yolo_model, video_reader)


if __name__ == "__main__":
    main()
