"""Insertion-state classifier task (EfficientNet or VAN, two classes: outside / inserted).

Counterpart of ``yolo_puncture_tpu/tasks/classify.py``:
  * ``ClassifierNet``: model, weights and the forward (resize where needed,
    ImageNet normalisation, softmax over the classes in fp32) on ``device``;
  * ``load_classify_net``: build a classifier, optionally from a timm checkpoint;
  * ``predict_images``: RGB crops of any size → (class indices, max probabilities),
    resized to input_size² with cv2's INTER_LINEAR arithmetic (``ops/resize.py``,
    no cv2 needed);
  * ``predict_and_find_start_inserted``: input_size² crops around each frame's
    box → classification → key-frame search → sequence repair.

PyTorch runs eagerly and eval-mode BatchNorm treats every frame alone, so a
short last batch is not padded to the batch size as in the JAX package.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.analytics.keyframe import find_insert_start, fix_class_prob
from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8
from yolo_puncture_tpu_torch.registry import create_model
from yolo_puncture_tpu_torch.utils.convert import (
    export_classifier_state_dict,
    extract_state_dict,
    load_classifier_state_dict,
    read_msgpack,
)
from yolo_puncture_tpu_torch.utils.device import resolve_device
from yolo_puncture_tpu_torch.utils.transform import crop_frames_batch

INPUT_IMG_SIZE = 380
NUM_CLASSES = 2


class ClassifierNet:
    """A registered classifier (``efficientnet_b*``, ``van_b*``) with its weights
    on ``device`` and the ``predict_images`` contract.

    Weights: ``checkpoint``, a timm ``.pth.tar`` / ``.pth`` file (or a published
    VAN one); else ``variables``, the JAX package's variable tree (``params`` +
    ``batch_stats``, or the path of its flax msgpack file) or a torch-keyed state
    dict; else a seeded random init from ``seed``.  dtype: the compute type, fp32 or bf16
    (the softmax stays fp32).  device: ``None`` (the card) or ``"cpu"``.
    """

    def __init__(
        self,
        model_name: str = "efficientnet_b3",
        checkpoint: Optional[str] = None,
        num_classes: int = NUM_CLASSES,
        input_size: int = INPUT_IMG_SIZE,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        variables=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = create_model(model_name, num_classes=num_classes, dtype=dtype)
        self.input_size = input_size
        if checkpoint:
            load_classifier_state_dict(self.model, extract_state_dict(checkpoint))
        elif variables is not None:
            if isinstance(variables, (str, bytes)):
                variables = read_msgpack(variables)
            if isinstance(variables, Mapping) and "params" in variables:
                variables = export_classifier_state_dict(variables)
            load_classifier_state_dict(self.model, variables)
        else:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def _forward(self, images_u8: torch.Tensor):
        """RGB uint8 (B, H, W, 3) on the model's device → (indices, max
        probabilities, probabilities (B, num_classes) fp32)."""
        logits = self.model(preprocess_classifier(images_u8, self.input_size, self.model.dtype))
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs.amax(dim=-1), probs

    def predict(self, images_rgb_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, H, W, 3) RGB uint8 → (indices, max probabilities) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(images_rgb_u8)).to(self.device)
        idx, p, _ = self._forward(x)
        return idx.cpu().numpy(), p.cpu().numpy()


def load_classify_net(
    checkpoint_name: Optional[str] = None,
    name: str = "efficientnet_b3",
    num_classes: int = NUM_CLASSES,
    **kw,
) -> ClassifierNet:
    return ClassifierNet(name, checkpoint=checkpoint_name, num_classes=num_classes, **kw)


def predict_images(model: ClassifierNet, images: Sequence[np.ndarray]):
    """List of RGB uint8 arrays (any size) → (indices list, probabilities list)."""
    size = (model.input_size, model.input_size)
    batch = torch.stack([
        resize_linear_u8(torch.from_numpy(np.ascontiguousarray(im)).to(model.device), size)
        for im in images
    ])
    idx, p, _ = model._forward(batch)
    return idx.cpu().tolist(), p.cpu().tolist()


def predict_and_find_start_inserted(
    model: ClassifierNet,
    frames: Optional[Sequence[np.ndarray]] = None,
    boxes_list: Optional[Sequence] = None,
    judge_wnd: int = 20,
    batch_size: int = 64,
) -> Tuple[List[int], List[float], int]:
    """BGR frames and their boxes → (classes, probabilities, key frame), repaired."""
    frames = list(frames or [])
    boxes_list = list(boxes_list or [])
    if len(frames) != len(boxes_list):
        raise ValueError("The length of frames and boxes_list must be the same.")
    if not frames:
        return [], [], 0

    # crop around each box first, then flip BGR → RGB on the crops only
    crops = crop_frames_batch(frames, np.asarray(boxes_list), model.input_size)[..., ::-1]
    class_list: List[int] = []
    prob_list: List[float] = []
    for i in range(0, len(crops), batch_size):
        idx, p = model.predict(crops[i:i + batch_size])
        class_list.extend(int(v) for v in idx)
        prob_list.extend(float(v) for v in p)

    insert_frame_index = find_insert_start(class_list, prob_list, judge_wnd)
    class_list, prob_list = fix_class_prob(class_list, prob_list, insert_frame_index)
    return class_list, prob_list, insert_frame_index
