"""Video and image-directory reading.

Counterpart of ``yolo_puncture_tpu/pipeline/video.py``.  ``VideoReader`` keeps
the reference dataset contract: a directory of images, or a video file split
into JPEG frames named ``{video_no}frame_{i}.jpg`` in a temporary directory,
sorted by ``sort_key`` (numbers compared as numbers); items are (RGB ndarray,
path).  ``iter_video_frames`` streams BGR frames from the container with a
background decode thread.  Decoding a video needs cv2 (and PIL for the JPEG
frames), imported where they are used: a machine without cv2 can read image
directories but no video file.
"""

from __future__ import annotations

import os
import queue
import re
import tempfile
import threading
from os import path
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMAGE_EXTENSIONS = [".jpg", ".jpeg", ".png"]
VIDEO_EXTENSIONS = [".mp4", ".avi"]


def sort_key(filename: str):
    """Numeric-aware filename sort key (video_reader.py:105-111)."""
    match = re.findall(r"\d+", filename)
    return list(map(int, match)) if match else [0]


class VideoReader:
    """Directory-of-images or video-file frame dataset (reference semantics)."""

    def __init__(self, images_path: str):
        self.images_path = images_path
        self.frames: List[str] = []
        self.output_dir: Optional[str] = None

        if path.isdir(images_path):
            for filename in os.listdir(images_path):
                file_path = path.join(images_path, filename)
                if path.isfile(file_path):
                    _, ext = path.splitext(filename)
                    if ext.lower() in IMAGE_EXTENSIONS:
                        self.frames.append(filename)
        elif path.isfile(images_path) and self._is_video_file(images_path):
            self._process_video_file(images_path)
        else:
            raise ValueError(
                "input path must be an image directory or a supported video file"
            )
        self.frames = sorted(self.frames, key=sort_key)

    @staticmethod
    def _is_video_file(filepath: str) -> bool:
        _, ext = path.splitext(filepath)
        return ext.lower() in VIDEO_EXTENSIONS

    def _process_video_file(self, video_path: str):
        import cv2
        from PIL import Image

        video_filename = path.basename(video_path)
        match = re.search(r"video(\d+)", video_filename, re.IGNORECASE)
        video_number = match.group(1) if match else ""
        self.output_dir = tempfile.mkdtemp()

        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise IOError(f"Unable to read file '{video_filename}'")
        frame_count = 0
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frame_filename = f"{video_number}frame_{frame_count}.jpg"
            Image.fromarray(frame[..., ::-1]).save(path.join(self.output_dir, frame_filename))
            frame_count += 1
        cap.release()
        for file in os.listdir(self.output_dir):
            if re.match(rf"^{re.escape(video_number)}frame_\d+\.jpg$", file, re.IGNORECASE):
                self.frames.append(file)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        from PIL import Image

        frame = self.frames[idx]
        im_path = path.join(self.output_dir or self.images_path, frame)
        img = np.array(Image.open(im_path).convert("RGB"))
        return img, im_path

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def iter_video_frames(
    video_path: str, prefetch: int = 64
) -> Tuple[float, int, int, Iterator[np.ndarray]]:
    """Stream BGR uint8 frames with a background decode thread.

    Returns (fps, width, height, iterator).
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"Unable to open video '{video_path}'")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _SENTINEL = object()

    def decode():
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                q.put(frame)
        finally:
            cap.release()
            q.put(_SENTINEL)

    threading.Thread(target=decode, daemon=True).start()

    def frames():
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item

    return fps, w, h, frames()
