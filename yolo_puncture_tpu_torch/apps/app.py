"""The interactive puncture-detection app: the port's ``apps/app.py``.

``yolo_inference`` is the JAX app's function with its arguments and returns
(plus ``device``):

  * image mode: ``YOLO.predict`` with retina masks on the RGB image (handed to
    the predictor as it is, as the reference does), the first instance's
    polygon filled yellow and added onto the image → (annotated RGB, None);
  * video mode: ``VideoSpeedPipeline`` (the detector, EfficientNet-B3 on
    crop_size² crops, ``device_batch`` frames a batch) over the decoded video,
    then per frame the ROI box with its ``{idx} {cls} {prob} {len} …`` label and
    U2NETP's mask of the crop around the box, both added onto the frame →
    (None, path of the annotated mp4).  ``annotate_video`` does this on decoded
    frames and returns the annotated frames and the info dict;
    ``yolo_inference`` wraps it between cv2's ``VideoCapture`` and
    ``VideoWriter``.  Each crop is zero-padded to crop_size² before U²-Net and
    the mask sliced back, as the JAX app does.
  * ``return_info`` appends the info dict the web UI answers with.

``cv2.addWeighted(a, 1, b, 1, 0)`` is ``saturating_add``.  Without cv2 no mp4
is read or written (``annotate_video`` runs all the same), polygons are filled
by the port's scanline fill and the ROI label is not drawn (only its box), as
in the JAX package's branch without cv2 (``ops/geometry.py create_roi_mask``).

``build_gradio_app`` is the reference's gradio Blocks UI, behind the optional
gradio import; ``main`` launches it.  Models run on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Tuple

import numpy as np

from yolo_puncture_tpu_torch.utils.config import get_config

CONFIG = get_config()

INIT_SHAFT_LEN = CONFIG.analytics.init_shaft_len_mm
MOVE_THRESHOLD = CONFIG.analytics.move_threshold_mm
CONFIRMATION_FRAMES = CONFIG.analytics.confirmation_frames
OUT_EXPAND = CONFIG.analytics.out_expand_px


def saturating_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """uint8 ``a + b`` clipped at 255: ``cv2.addWeighted(a, 1, b, 1, 0)``."""
    return np.minimum(a.astype(np.uint16) + b, 255).astype(np.uint8)


def weights_path(p: str) -> str:
    """``p`` under the configured weights directory where that file exists, else ``p``."""
    full = os.path.join(CONFIG.PATH.WEIGHTS_PATH, p)
    return full if os.path.exists(full) else p


def build_detector(yolo_model_id: str, device=None):
    """The app's detector with its calibration sidecar (``yolo_cli calibrate``):
    the UI's default conf of 0.9 then reads on the calibrated scale."""
    from yolo_puncture_tpu_torch import YOLO

    model = YOLO(weights_path(yolo_model_id), nc=1, device=device)
    model.load_calibration(os.path.dirname(weights_path(yolo_model_id)) or ".")
    return model


def build_video_models(model, unet_seg_model_id: str, classify_model_id: str, device_batch: int, imgsz: int,
                       crop_size: int):
    """(the speed pipeline over ``model`` and B3, U2NETP) on ``model``'s device,
    each from its file where that exists, else a seeded init."""
    from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
    from yolo_puncture_tpu_torch.tasks import ClassifierNet, UNetPredictor

    unet_path, cls_path = weights_path(unet_seg_model_id), weights_path(classify_model_id)
    unet = UNetPredictor("u2netp", checkpoint=unet_path if os.path.exists(unet_path) else None,
                         device=model.device)
    cls_net = ClassifierNet("efficientnet_b3", checkpoint=cls_path if os.path.exists(cls_path) else None,
                            device=model.device)
    pipe = VideoSpeedPipeline(model, cls_net, device_batch=device_batch, imgsz=imgsz, crop_size=crop_size)
    return pipe, unet


def annotate_video(frames: List[np.ndarray], fps: float, pipe, unet, conf: float, judge_wnd: int,
                   crop_size: int) -> Tuple[List[np.ndarray], dict]:
    """Video mode on decoded BGR frames: (annotated BGR frames, info dict)."""
    from yolo_puncture_tpu_torch.ops.geometry import create_roi_mask
    from yolo_puncture_tpu_torch.tasks import unet_predict
    from yolo_puncture_tpu_torch.utils.transform import crop_frame

    out = pipe.process_frames(frames, fps, conf=conf, judge_wnd=judge_wnd)
    h, w = frames[0].shape[:2] if frames else (0, 0)
    # the pipeline's smoothed lengths and state machine, reused so that the labels match it
    smooth, actual_lens = out.smooth_lens, out.actual_lens
    annotated = []
    inserted, last_xyxy = False, None
    for idx, frame in enumerate(frames):
        cls, prob = out.classes[idx], out.probs[idx]
        rect_len, actual_len = smooth[idx], actual_lens[idx]
        if inserted and last_xyxy is not None:
            x1, y1, x2, y2 = last_xyxy
        else:
            x1, y1, x2, y2 = out.boxes[idx]
            x1, y1 = max(0, x1 - OUT_EXPAND), max(0, y1 - OUT_EXPAND)
            x2, y2 = min(w, x2 + OUT_EXPAND), min(h, y2 + OUT_EXPAND)
            last_xyxy = (x1, y1, x2, y2)
        if idx == out.start_frame:
            inserted = True
        if out.end_frame is not None and idx >= out.end_frame:
            inserted = False

        if out.end_frame is not None and idx >= out.end_frame and out.speed_mm_s:
            label = f"{idx} {cls} {prob:.2f} {out.speed_mm_s:.2f}mm/s"
        elif np.isnan(actual_len):
            label = f"{idx} {cls} {prob:.2f} -"
        else:
            label = f"{idx} {cls} {prob:.2f} {actual_len:.2f} {rect_len:.2f}"

        mask = np.zeros(frame.shape, np.uint8)
        cropped, (x_lt, y_lt, x_rd, y_rd) = crop_frame(frame, out.boxes[idx], crop_size=crop_size)
        if cropped.shape[0] and cropped.shape[1]:
            padded = np.zeros((crop_size, crop_size, 3), np.uint8)
            ch, cw = cropped.shape[:2]
            padded[:ch, :cw] = cropped[:crop_size, :crop_size]
            cm = unet_predict(unet, padded)
            mask[y_lt:y_rd, x_lt:x_rd, 1] = cm[:y_rd - y_lt, :x_rd - x_lt]
        roi = create_roi_mask(frame.shape, x1, y1, x2, y2, label)
        annotated.append(saturating_add(saturating_add(frame, mask), roi))
    info = {"mode": "video", "start_frame": out.start_frame, "end_frame": out.end_frame,
            "speed_mm_s": out.speed_mm_s, "fps": float(fps), "n_frames": len(frames)}
    return annotated, info


def yolo_inference(
    image,
    video,
    yolo_model_id: str = "seg/yolo11n-seg-finetune.pt",
    unet_seg_model_id: str = "u2netp_finetune_70.pth",
    classify_model_id: str = "EfficientNet/efficientnet_b3.pth.tar",
    yolo_conf_threshold: float = 0.9,
    judge_wnd: int = 20,
    imgsz: int = 640,
    device_batch: int = 8,
    crop_size: int = 380,
    return_info: bool = False,
    device=None,
):
    """Image mode returns (annotated RGB image, None); video mode returns
    (None, annotated video path).  With ``return_info`` a third element is the
    info dict (video: start and end frame, speed, fps, frame count; image: the
    number of detections)."""
    model = build_detector(yolo_model_id, device)
    if image is not None:
        from yolo_puncture_tpu_torch.ops.geometry import polygon_to_mask

        r = model.predict(source=image, conf=yolo_conf_threshold, retina_masks=True, imgsz=imgsz)[0]
        img = np.array(image)[..., ::-1].copy()  # RGB → BGR, as the reference does
        if r.masks is not None and len(r.masks):
            img = saturating_add(img, polygon_to_mask(img.shape, r.masks.xy[0]))
        if return_info:
            return img[:, :, ::-1], None, {"mode": "image", "detections": int(len(r.boxes.conf))}
        return img[:, :, ::-1], None

    import cv2

    pipe, unet = build_video_models(model, unet_seg_model_id, classify_model_id, device_batch, imgsz, crop_size)
    cap = cv2.VideoCapture(video)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()

    annotated, info = annotate_video(frames, fps, pipe, unet, yolo_conf_threshold, judge_wnd, crop_size)
    fd, output_video_path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    h, w = frames[0].shape[:2] if frames else (0, 0)
    writer = cv2.VideoWriter(output_video_path, cv2.VideoWriter.fourcc(*"MP4V"), fps, (w, h))
    for frame in annotated:
        writer.write(frame)
    writer.release()
    if info["speed_mm_s"]:
        print(f"Start: {info['start_frame']} End: {info['end_frame']} Speed: {info['speed_mm_s']:.2f}mm/s")
    if return_info:
        return None, output_video_path, info
    return None, output_video_path


def build_gradio_app():
    """The gradio Blocks UI of the reference app.  Requires gradio."""
    import gradio as gr

    with gr.Blocks() as demo:
        gr.HTML("<h1 style='text-align: center'>Puncture Detection</h1>")
        with gr.Row():
            with gr.Column():
                image = gr.Image(type="pil", label="Image", visible=False)
                video = gr.Video(label="Video", visible=True)
                input_type = gr.Radio(["Image", "Video"], value="Video", label="Input Type")
                yolo_model_id = gr.Dropdown(
                    label="YOLO Model",
                    choices=[
                        "seg/yolov8n-seg-finetune.pt",
                        "seg/yolo11n-seg-finetune.pt",
                        "seg/yolo11x-seg-finetune.pt",
                    ],
                    value="seg/yolo11n-seg-finetune.pt",
                )
                unet_seg_model_id = gr.Dropdown(
                    label="UNet Model", choices=["u2netp_finetune_70.pth"],
                    value="u2netp_finetune_70.pth",
                )
                classify_model_id = gr.Dropdown(
                    label="Classify Model",
                    choices=["EfficientNet/efficientnet_b3.pth.tar"],
                    value="EfficientNet/efficientnet_b3.pth.tar",
                )
                conf = gr.Slider(0.0, 1.0, step=0.05, value=0.9, label="Confidence Threshold")
                judge = gr.Slider(10, 40, step=5, value=20,
                                  label="Window Size for Judging Insert-starting Frame")
                btn = gr.Button(value="Detect Objects")
            with gr.Column():
                out_img = gr.Image(type="numpy", label="Annotated Image", visible=False)
                out_vid = gr.Video(label="Annotated Video", visible=True)

        def vis(t):
            im = t == "Image"
            return (
                gr.update(visible=im), gr.update(visible=not im),
                gr.update(visible=im), gr.update(visible=not im),
            )

        input_type.change(vis, [input_type], [image, video, out_img, out_vid])

        def run(image, video, ym, um, cm, conf, judge, t):
            if t == "Image":
                return yolo_inference(image, None, ym, um, cm, conf, int(judge))
            return yolo_inference(None, video, ym, um, cm, conf, int(judge))

        btn.click(
            run,
            [image, video, yolo_model_id, unet_seg_model_id, classify_model_id, conf, judge, input_type],
            [out_img, out_vid],
        )
    return demo


def main():
    try:
        app = build_gradio_app()
    except ImportError:
        print("gradio is not installed; use yolo_inference() directly "
              "or apps/auto_speed_calc.py for headless runs.")
        return
    app.launch(ssl_verify=False)


if __name__ == "__main__":
    main()
