"""Fine-tune loops for the auxiliary model families: the insertion classifier and U²-Net.

Counterpart of ``yolo_puncture_tpu/train/finetune.py``:

  * ``ClassifierFinetuner``: softmax cross-entropy on RGB box crops
    (``preprocess_classifier``), Adam with optax's defaults; the dataset layout of
    ``tools/dataset_gen.py`` (``cls x y w h`` normalised labels,
    ``load_cls_bbox_dataset``);
  * ``UNetFinetuner``: U²-Net's objective, the sum of BCE over the seven side
    outputs against a binary mask;
  * ``recalibrate_batch_stats``: after a fit, each BatchNorm's running statistics
    become the batch-size-weighted mean, over the fit's batches, of its true batch
    mean and biased variance.

The models train with flax's BatchNorm (``nn/common.py BatchNorm2d``: the batch's
biased variance in the running statistics, EfficientNet's momentum 0.99, VAN's and
U²-Net's 0.9 as the JAX package sets them).  VAN has no dropout: its ``forward``
takes the fine-tuner's generator and ignores it.  ``fit_arrays`` visits the batches in
the order of ``numpy.random.default_rng(seed).permutation``, as the JAX package
does.  The classifier's head dropout draws its mask from a ``torch.Generator``
seeded with ``seed``, once a step (the JAX package folds the step into
``PRNGKey(seed)``: the masks are not the same bits).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
from yolo_puncture_tpu_torch.nn.common import BatchNorm2d


@torch.no_grad()
def recalibrate_batch_stats(model: torch.nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Set each ``BatchNorm2d`` of ``model`` to the exact statistics of ``batches``:
    the batch-size-weighted mean, over the batches, of the mean and the biased
    variance (E[x²] − E[x]², floored at 0, as flax computes it) that the layer sees
    in a train-mode forward.  The JAX package recovers the same numbers from two
    train-mode passes at running statistics 0 and 1; here hooks read them.
    Returns the new statistics by buffer name; ``model`` is left in ``eval()``."""
    layers = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    sums: Dict[str, List[torch.Tensor]] = {}

    def hook(name):
        def read(module, args):
            x = args[0].to(torch.float64)
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            w = x.shape[0]
            acc = sums.setdefault(name, [torch.zeros_like(mean), torch.zeros_like(var)])
            acc[0] += w * mean
            acc[1] += w * var
        return read

    handles = [m.register_forward_pre_hook(hook(name)) for name, m in layers.items()]
    total = 0
    model.train()
    try:
        for x in batches:
            model(x)
            total += x.shape[0]
    finally:
        for h in handles:
            h.remove()
        model.eval()
    out = {}
    if total:
        for name, m in layers.items():
            mean, var = (a / total for a in sums[name])
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = m.running_mean, m.running_var
    return out


def _adam(params, lr: float) -> torch.optim.Adam:
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square root
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


def load_cls_bbox_dataset(root: str, split: str = "train") -> List[Tuple[str, int, Tuple]]:
    """(image_path, cls, xywhn) from the dataset_gen layout."""
    img_dir = os.path.join(root, "images", split)
    lbl_dir = os.path.join(root, "labels", split)
    items = []
    for f in sorted(os.listdir(img_dir)):
        if not f.lower().endswith((".jpg", ".png", ".jpeg")):
            continue
        lbl = os.path.join(lbl_dir, os.path.splitext(f)[0] + ".txt")
        if not os.path.exists(lbl):
            continue
        with open(lbl) as fh:
            vals = fh.read().split()
        if len(vals) < 5:
            continue
        items.append((os.path.join(img_dir, f), int(float(vals[0])), tuple(map(float, vals[1:5]))))
    return items


class ClassifierFinetuner:
    def __init__(self, net, lr: float = 1e-4, seed: int = 0):
        """net: ``tasks/classify.py ClassifierNet``; its model is trained in place."""
        self.net = net
        self.opt = _adam(net.model.parameters(), lr)
        self.rng = np.random.default_rng(seed)
        self.dropout = torch.Generator(net.device).manual_seed(seed)

    def step(self, images_u8: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on RGB uint8 crops (B, H, W, 3) and integer labels on the
        model's device; returns (loss, accuracy) as device scalars."""
        model = self.net.model
        model.train()
        x = preprocess_classifier(images_u8, self.net.input_size, model.dtype)
        logits = model(x, dropout_generator=self.dropout).float()
        loss = F.cross_entropy(logits, labels.long())
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        model.eval()
        return loss.detach(), (logits.argmax(-1) == labels).float().mean()

    def fit_arrays(self, crops_u8: np.ndarray, labels: np.ndarray, epochs: int = 1, batch_size: int = 16,
                   log_every: int = 20) -> Tuple[Optional[float], Optional[float]]:
        """``epochs`` passes over the crops in batches of ``batch_size`` (a last
        partial batch is dropped), then ``recalibrate_batch_stats`` over the crops
        in order.  Returns the last step's (loss, accuracy)."""
        dev = self.net.device
        n = len(crops_u8)
        it = 0
        loss = acc = None
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                loss, acc = self.step(torch.from_numpy(np.ascontiguousarray(crops_u8[idx])).to(dev),
                                      torch.from_numpy(np.asarray(labels[idx])).to(dev))
                it += 1
                if log_every and it % log_every == 0:
                    print(f"cls step {it}: loss {float(loss):.4f} acc {float(acc):.3f}")
        model, size = self.net.model, self.net.input_size
        recalibrate_batch_stats(model, (
            preprocess_classifier(torch.from_numpy(np.ascontiguousarray(crops_u8[i:i + batch_size])).to(dev), size,
                                  model.dtype)
            for i in range(0, n - batch_size + 1, batch_size)))
        return (float(loss) if loss is not None else None, float(acc) if acc is not None else None)

    @staticmethod
    def crops_from_dataset(root: str, split: str, crop_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """RGB crops (N, crop_size, crop_size, 3) around each labelled box, and the
        labels; PNG files are read without cv2 (``utils/png.py decode_image``)."""
        from yolo_puncture_tpu_torch.utils.png import decode_image
        from yolo_puncture_tpu_torch.utils.transform import crop_frame

        crops, labels = [], []
        for path, cls, (x, y, w, h) in load_cls_bbox_dataset(root, split):
            with open(path, "rb") as f:
                img = decode_image(f.read())
            if img is None:
                raise ValueError(f"cannot read {path}")
            img = img[..., ::-1]  # RGB
            H, W = img.shape[:2]
            xyxy = ((x - w / 2) * W, (y - h / 2) * H, (x + w / 2) * W, (y + h / 2) * H)
            crop, _ = crop_frame(img, xyxy, crop_size, need_padding=True)
            canvas = np.zeros((crop_size, crop_size, 3), np.uint8)
            canvas[:crop.shape[0], :crop.shape[1]] = crop[:crop_size, :crop_size]
            crops.append(canvas)
            labels.append(cls)
        return np.stack(crops), np.asarray(labels, np.int32)


# ---------------------------------------------------------------------------
# U²-Net
# ---------------------------------------------------------------------------


def u2net_loss(outs, masks: torch.Tensor) -> torch.Tensor:
    """The sum over U²-Net's seven sigmoid outputs (B, 1, H, W) of the mean BCE
    against ``masks`` (B, H, W), each probability clipped to [1e-6, 1 − 1e-6]."""
    total = 0.0
    for d in outs:
        p = d[:, 0].float().clamp(1e-6, 1 - 1e-6)
        total = total + (-(masks * torch.log(p) + (1 - masks) * torch.log(1 - p))).mean()
    return total


class UNetFinetuner:
    def __init__(self, predictor, lr: float = 1e-4, seed: int = 0):
        """predictor: ``tasks/unet.py UNetPredictor``; its model is trained in place."""
        self.predictor = predictor
        self.opt = _adam(predictor.model.parameters(), lr)
        self.rng = np.random.default_rng(seed)

    def step(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """One Adam step on RGB images in [0, 1] (B, H, W, 3) and masks (B, H, W);
        returns the loss as a device scalar."""
        model = self.predictor.model
        model.train()
        loss = u2net_loss(model(images.permute(0, 3, 1, 2)), masks)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        model.eval()
        return loss.detach()

    def fit_arrays(self, images_rgb01: np.ndarray, masks01: np.ndarray, epochs: int = 1, batch_size: int = 4,
                   log_every: int = 20) -> Optional[float]:
        """As ``ClassifierFinetuner.fit_arrays``; returns the last step's loss."""
        dev = self.predictor.device
        dtype = next(self.predictor.model.parameters()).dtype
        n = len(images_rgb01)
        it = 0
        loss = None

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                loss = self.step(tensor(images_rgb01[idx]), tensor(masks01[idx]))
                it += 1
                if log_every and it % log_every == 0:
                    print(f"u2net step {it}: loss {float(loss):.4f}")
        recalibrate_batch_stats(self.predictor.model, (
            tensor(images_rgb01[i:i + batch_size]).permute(0, 3, 1, 2)
            for i in range(0, n - batch_size + 1, batch_size)))
        return float(loss) if loss is not None else None
