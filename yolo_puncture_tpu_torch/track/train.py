"""Propagation-network training: teaches the tracker to carry masks through time.

Counterpart of ``yolo_puncture_tpu/track/train.py``.  VOS-style recurrent
training: memory is seeded with the ground-truth mask at t = 0
(``_incorporate_impl``), the tracker rolls forward through the clip writing its
own predictions into memory, exactly as at inference, and every later frame's
aggregated probabilities are supervised with per-pixel cross-entropy against
the ground-truth id map.  The clips are synthetic (moving bars, domain-randomised
needle-like objects, thin serving-geometry needle shafts), drawn with numpy from
a ``default_rng``: the same seed gives the JAX package's arrays exactly.

What differs from the JAX package, on purpose:

  * the rollout runs the port's device programs (``TrackerCore._incorporate_impl``
    / ``_step_impl`` / ``_window_impl``), whose readout and decode tail are the
    hand-written kernels on the card (``ops/kernels``), with their gradients
    through ``MemoryReadout`` and ``DecodeTail``;
  * ``lax.scan`` over frames and ``vmap`` over clips are Python loops; the clip
    batch's loss is the mean over clips, and each clip's graph is freed after
    its backward;
  * the weights live in ``core.net``: Adam (``torch.optim.Adam``, ``optax.adam``'s
    defaults and update ``m̂ / (√v̂ + eps)``) updates its ``nn.Parameter``s only,
    the BatchNorm running statistics are buffers and stay frozen, and the network
    stays in ``eval()`` so that BatchNorm uses them, as flax's
    ``use_running_average`` forward with ``set_to_zero`` on ``batch_stats`` does;
  * a bf16 core trains as the JAX package trains ``TrackerCore(dtype=bfloat16)``:
    Adam holds fp32 masters (``nn/common.py MasterWeights``), the rollout runs the
    bf16 network (the kernels' bf16 routes, ``MemoryReadout`` and ``DecodeTail``
    with their bf16 backward), each clip's bf16 gradients are added to the
    masters' fp32 ones, and after the update the masters are rounded into the
    network.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_puncture_tpu_torch.models.yolo import pyramid_channels_for  # noqa: F401  (the JAX module's name)
from yolo_puncture_tpu_torch.nn.common import MasterWeights
from yolo_puncture_tpu_torch.track.core import TrackerCore
from yolo_puncture_tpu_torch.track.network import clip


def make_synthetic_clip(
    rng: np.random.Generator,
    T: int = 4,
    h: int = 64,
    w: int = 96,
    max_objects: int = 2,
):
    """Moving-bar clip: images (T, h, w, 3) float[0,1], onehot masks (T, No, h, w)."""
    n_obj = int(rng.integers(1, max_objects + 1))
    images = rng.uniform(0, 0.15, size=(T, h, w, 3)).astype(np.float32)
    masks = np.zeros((T, max_objects, h, w), np.float32)
    for o in range(n_obj):
        bw = int(rng.integers(w // 4, w // 2))
        bh = int(rng.integers(4, h // 4))
        x = float(rng.integers(0, w - bw))
        y = float(rng.integers(0, h - bh))
        dx = float(rng.uniform(-3, 3))
        dy = float(rng.uniform(-2, 2))
        color = rng.uniform(0.5, 1.0, size=3)
        for t in range(T):
            x1 = int(np.clip(x + dx * t, 0, w - bw))
            y1 = int(np.clip(y + dy * t, 0, h - bh))
            images[t, y1 : y1 + bh, x1 : x1 + bw] = color
            masks[t, o, y1 : y1 + bh, x1 : x1 + bw] = 1.0
    return images, masks


def _box_smooth(base: np.ndarray, k: int) -> np.ndarray:
    """Two-pass box smoothing by cumulative sums (one pass per image axis)."""
    for ax in (0, 1):
        c = np.cumsum(base, axis=ax)
        lo = np.roll(c, k, axis=ax)
        idx = [slice(None)] * 3
        idx[ax] = slice(0, k)
        lo[tuple(idx)] = 0
        base = (c - lo) / k
    return base


def make_domain_randomized_clip(
    rng: np.random.Generator,
    T: int = 4,
    h: int = 64,
    w: int = 96,
    max_objects: int = 2,
):
    """Domain-randomised clips: textured, drifting or dark backgrounds, rotated
    elongated (needle-like) or axis-aligned objects, translation, rotation and an
    optional length shrink (insertion motion), per-frame illumination jitter, and
    in a third of the clips a dark elliptical occluder sweeping across (occluded
    pixels belong to no object).  Returns (images (T, h, w, 3) float[0,1],
    onehot (T, No, h, w))."""
    n_obj = int(rng.integers(1, max_objects + 1))
    occluder = rng.random() < 0.35
    if occluder:
        occ = dict(
            cy=h * rng.uniform(0.3, 0.7), ry=h * rng.uniform(0.15, 0.3),
            rx=w * rng.uniform(0.08, 0.2),
            x0=-w * 0.2, vx=w * (0.2 + 0.8 * rng.random()) / max(T - 1, 1),
            color=rng.uniform(0.0, 0.15, size=3),
        )
    if rng.random() < 0.45:
        base = np.full((h + 32, w + 32, 3), rng.uniform(0.0, 0.2), np.float32)
        base += rng.uniform(0, 0.1, size=base.shape).astype(np.float32)
    else:
        base = rng.uniform(0.15, 0.65, size=(h + 32, w + 32, 3)).astype(np.float32)
        base = _box_smooth(base, int(rng.integers(4, 10)))
    gy = np.linspace(0, rng.uniform(0, 0.2), h + 32)[:, None, None]
    base = np.clip(base + gy, 0, 1).astype(np.float32)
    drift = (int(rng.integers(0, 3)), int(rng.integers(0, 3)))

    images = np.zeros((T, h, w, 3), np.float32)
    masks = np.zeros((T, max_objects, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    objs = []
    for _ in range(n_obj):
        objs.append(dict(
            cx=w * rng.uniform(0.25, 0.75), cy=h * rng.uniform(0.25, 0.75),
            angle=rng.uniform(-0.7, 0.7) if rng.random() < 0.7 else 0.0,
            length=min(h, w) * rng.uniform(0.3, 0.85),
            width=min(h, w) * rng.uniform(0.05, 0.3),
            vx=rng.uniform(-3, 3), vy=rng.uniform(-2, 2),
            va=rng.uniform(-0.03, 0.03),
            shrink=rng.uniform(0.0, 0.05) if rng.random() < 0.5 else 0.0,
            color=rng.uniform(0.55, 1.0, size=3),
        ))

    for t in range(T):
        oy = (drift[1] * t) % 32
        ox = (drift[0] * t) % 32
        img = base[oy:oy + h, ox:ox + w].copy()
        img *= rng.uniform(0.9, 1.1)
        frame_ids = np.zeros((h, w), np.int32)  # later objects occlude earlier ones
        for o, p in enumerate(objs):
            a = p["angle"] + p["va"] * t
            ca, sa = np.cos(a), np.sin(a)
            lcur = p["length"] * max(1.0 - p["shrink"] * t, 0.3)
            u = (xx - (p["cx"] + p["vx"] * t)) * ca + (yy - (p["cy"] + p["vy"] * t)) * sa
            v = -(xx - (p["cx"] + p["vx"] * t)) * sa + (yy - (p["cy"] + p["vy"] * t)) * ca
            m = (np.abs(u) < lcur / 2) & (np.abs(v) < p["width"] / 2)
            img[m] = p["color"] * rng.uniform(0.95, 1.05)
            frame_ids[m] = o + 1
        if occluder:
            ocx = occ["x0"] + occ["vx"] * t
            om = (((xx - ocx) / occ["rx"]) ** 2
                  + ((yy - occ["cy"]) / occ["ry"]) ** 2) < 1.0
            img[om] = occ["color"]
            frame_ids[om] = 0
        for o in range(n_obj):
            masks[t, o] = (frame_ids == o + 1).astype(np.float32)
        images[t] = np.clip(img, 0, 1)
    return images, masks


def make_needle_serving_clip(
    rng: np.random.Generator,
    T: int = 4,
    h: int = 64,
    w: int = 96,
    max_objects: int = 2,
):
    """Serving-aligned clips: a textured background with a skin band and thin
    bright rotated needle shafts (1.4–3.0 % of the shorter side wide) that shrink
    after a key frame and drift sideways, sometimes under an occluder; 30 % of
    the draws are ``make_domain_randomized_clip`` instead.  Same contract."""
    if rng.random() < 0.30:
        return make_domain_randomized_clip(rng, T, h, w, max_objects)
    n_obj = int(rng.integers(1, min(2, max_objects) + 1))
    size = min(h, w)
    base = rng.uniform(0.22, 0.49, size=(h + 32, w + 32, 3)).astype(np.float32)
    base = _box_smooth(base, 6)
    skin_y = int(h * rng.uniform(0.62, 0.78))
    skin = np.array([
        rng.uniform(0.47, 0.59), rng.uniform(0.51, 0.65), rng.uniform(0.67, 0.80)
    ], np.float32)
    base[skin_y:] = 0.25 * base[skin_y:] + 0.75 * skin
    drift_bg = (int(rng.integers(0, 3)), int(rng.integers(0, 3)))

    occluder = rng.random() < 0.25
    if occluder:
        occ = dict(
            cy=skin_y * rng.uniform(0.55, 0.95), ry=h * rng.uniform(0.10, 0.16),
            rx=w * rng.uniform(0.08, 0.12),
            x0=-w * 0.15, vx=w * (0.2 + 0.8 * rng.random()) / max(T - 1, 1),
            color=rng.uniform(0.0, 0.15, size=3),
        )

    objs = []
    for kk in range(n_obj):
        L = size * rng.uniform(0.22, 0.45)
        objs.append(dict(
            cx=w * ((0.5 + kk) / max(n_obj, 1) * 0.6 + rng.uniform(0.08, 0.25)),
            L=L,
            W=max(size * rng.uniform(0.014, 0.030), 2.5),
            theta=rng.uniform(np.radians(55), np.radians(125)),
            key=int(rng.integers(0, max(T // 2, 1))),
            rate=L * rng.uniform(0.0, 0.10),        # shrink px/frame after the key frame
            vx=rng.uniform(-2.5, 2.5),
            color=rng.uniform(0.84, 0.98, size=3),
        ))

    images = np.zeros((T, h, w, 3), np.float32)
    masks = np.zeros((T, max_objects, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for t in range(T):
        oy = (drift_bg[1] * t) % 32
        ox = (drift_bg[0] * t) % 32
        img = base[oy:oy + h, ox:ox + w].copy()
        img *= rng.uniform(0.95, 1.05)
        frame_ids = np.zeros((h, w), np.int32)
        for o, p in enumerate(objs):
            L = max(p["L"] - p["rate"] * max(t - p["key"], 0), 0.08 * size)
            cx = p["cx"] + p["vx"] * t
            cy = skin_y - L * 0.35
            ca, sa = np.cos(p["theta"]), np.sin(p["theta"])
            u = (xx - cx) * ca + (yy - cy) * sa
            v = -(xx - cx) * sa + (yy - cy) * ca
            m = (np.abs(u) < L / 2) & (np.abs(v) < p["W"] / 2)
            img[m] = p["color"] * rng.uniform(0.97, 1.03)
            frame_ids[m] = o + 1
        if occluder:
            ocx = occ["x0"] + occ["vx"] * t
            om = (((xx - ocx) / occ["rx"]) ** 2
                  + ((yy - occ["cy"]) / occ["ry"]) ** 2) < 1.0
            img[om] = occ["color"]
            frame_ids[om] = 0
        for o in range(max_objects):
            masks[t, o] = (frame_ids == o + 1).astype(np.float32)
        images[t] = np.clip(img, 0, 1)
    return images, masks


def ce_of(prob: torch.Tensor, m_t: torch.Tensor, obj_valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross-entropy of aggregated probabilities (No+1, H, W) against
    the ground truth (No, H, W) of the valid objects, background first."""
    gt_fg = m_t * obj_valid[:, None, None]
    gt_bg = clip(1.0 - gt_fg.sum(0, keepdim=True), 0.0, 1.0)
    gt = torch.cat([gt_bg, gt_fg], dim=0)
    gt = gt / torch.maximum(gt.sum(0, keepdim=True), gt.new_tensor(1e-6))
    return -(gt * torch.log(clip(prob, 1e-6, 1.0))).sum(0).mean()


def _chw(images: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) → (T, 3, H, W)."""
    return images.permute(0, 3, 1, 2)


def build_windowed_propagation_loss(core: TrackerCore, window: int):
    """Like ``build_propagation_loss``, through the windowed propagation program
    (``_window_impl``: one readout and decode tail for the window against the
    window-start memory, one write at its end), so that the batched serving path
    is exposure-consistent with training.  Needs (T − 1) % window == 0."""

    def loss_fn(images, onehot, obj_valid):
        T = images.shape[0]
        if (T - 1) % window:
            raise ValueError("clip_len-1 must be a multiple of window")
        imgs = _chw(images).to(core.dtype)
        _, memory, _ = core._incorporate_impl(core.memory, imgs[0], onehot[0], obj_valid > 0.5)
        total = 0.0
        for s in range(1, T, window):
            probs, memory = core._window_impl(memory, imgs[s:s + window])
            for i in range(window):
                total = total + ce_of(probs[i], onehot[s + i], obj_valid)
        return total / (T - 1)

    return loss_fn


def build_propagation_loss(core: TrackerCore, pyramid_fn=None):
    """loss(images (T, H, W, 3), onehot (T, No, H, W), valid (No,)) → scalar.

    The rollout is the inference programs' own (``_incorporate_impl`` /
    ``_step_impl``), so training and serving see the same memory.  With
    ``pyramid_fn`` (images (T, H, W, 3) → the frozen detector's pyramid, a dict of
    channels-last P3 / P4 / P5, taken without a gradient) the rollout trains the
    shared-backbone path: features from ``core.encode_pyramid`` (the pyramid
    adapter and the decoder train), then ``_incorporate_from_feats`` /
    ``_step_from_feats``."""

    def loss_fn(images, onehot, obj_valid):
        T = images.shape[0]
        mem0 = core.memory
        valid_b = obj_valid > 0.5
        if pyramid_fn is not None:
            with torch.no_grad():
                pyr = pyramid_fn(images)
            keys, skips = core.encode_pyramid(*(pyr[k].permute(0, 3, 1, 2) for k in ("P3", "P4", "P5")))
            frame = [(keys[t], {k: v[t] for k, v in skips.items()}) for t in range(T)]
            _, memory, _ = core._incorporate_from_feats(mem0, *frame[0], onehot[0], valid_b)
        else:
            imgs = _chw(images).to(core.dtype)
            _, memory, _ = core._incorporate_impl(mem0, imgs[0], onehot[0], valid_b)
        total = 0.0
        for t in range(1, T):
            if pyramid_fn is not None:
                prob, memory = core._step_from_feats(memory, *frame[t])
            else:
                prob, memory = core._step_impl(memory, imgs[t])
            total = total + ce_of(prob, onehot[t], obj_valid)
        return total / (T - 1)

    return loss_fn


def make_yolo_pyramid_fn(
    version: str = "v10",
    scale: str = "s",
    seed: int = 0,
    dtype=torch.float32,
    ratio: float = 4.0 / 3.0,
    variables=None,
    device=None,
):
    """The frozen YOLO backbone as the pyramid source of shared-backbone
    training, as in the fused bench: the detector sees the frame resized
    (``ops/resize.py resize_bilinear``, ``jax.image.resize``'s bilinear) to
    ``ratio`` × the tracker geometry rounded to a multiple of 32 (640² detector /
    480² tracker → 4/3).  ``variables``: a flax variable tree of the detector
    (e.g. ``read_msgpack`` of ``--backbone_init``), else a seeded init.  Returns
    (pyramid_fn images (T, h, w, 3) → {P3, P4, P5} channels-last, the model)."""
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.ops.resize import resize_bilinear
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict
    from yolo_puncture_tpu_torch.utils.device import resolve_device

    model = YOLOModel(version=version, scale=scale, nc=1, task="segment", dtype=dtype)
    if variables is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_yolo_state_dict(model, export_yolo_state_dict(variables))
    model = model.to(resolve_device(device)).eval().requires_grad_(False)

    @torch.no_grad()
    def pyramid_fn(images):
        T, h, w = images.shape[:3]
        hb = int(round(h * ratio / 32)) * 32
        wb = int(round(w * ratio / 32)) * 32
        return model(resize_bilinear(images.to(dtype), (hb, wb)))["pyramid"]

    return pyramid_fn, model


class PropagationTrainer:
    """Adam over the tracker's parameters (their fp32 masters, ``self.params``)
    on batches of synthetic clips.  ``window_mix`` > 0 trains that fraction of the
    steps through the windowed program (``build_windowed_propagation_loss``)."""

    def __init__(
        self,
        core: TrackerCore,
        lr: float = 3e-4,
        clip_len: int = 4,
        batch_size: int = 1,
        seed: int = 0,
        pyramid_fn=None,
        clip_fn=None,
        window_mix: float = 0.0,
        window: int = 4,
    ):
        self.core = core
        self.clip_len = clip_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pyramid_fn = pyramid_fn
        self.clip_fn = clip_fn or make_synthetic_clip
        self.window_mix = float(window_mix)
        self.window = int(window)
        self.weights = MasterWeights(core.net)
        self.params = self.weights.masters
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.loss_fn = build_propagation_loss(core, pyramid_fn=pyramid_fn)
        self.window_loss_fn = None
        if self.window_mix > 0:
            if pyramid_fn is not None:
                raise ValueError("window_mix training is for the self-contained "
                                 "encoder path (pyramid_fn=None)")
            if (clip_len - 1) % self.window:
                raise ValueError(
                    f"clip_len-1 ({clip_len - 1}) must be a multiple of "
                    f"window ({self.window}) for windowed rollouts"
                )
            self.window_loss_fn = build_windowed_propagation_loss(core, self.window)

    def _sample_batch(self):
        """(images (B, T, h, w, 3), onehot (B, T, No, h, w), valid (B, No)) on the
        tracker's device, drawn from ``self.rng``."""
        h, w = self.core.image_size
        No = self.core.max_objects
        imgs, msks, valids = [], [], []
        for _ in range(self.batch_size):
            images, masks = self.clip_fn(self.rng, self.clip_len, h, w, max_objects=No)
            imgs.append(images)
            msks.append(masks)
            valids.append((masks.sum((0, 2, 3)) > 0).astype(np.float32))
        dev = self.core.device
        return tuple(torch.from_numpy(np.stack(a)).to(dev) for a in (imgs, msks, valids))

    def loss_and_grads(self, images, onehot, obj_valid, windowed: bool = False) -> float:
        """The batch's mean loss, its gradient accumulated in fp32 into the
        masters' ``.grad`` (cleared first; a parameter the loss does not reach gets
        zeros, as the JAX gradient has them); returns the loss."""
        loss_fn = self.window_loss_fn if windowed else self.loss_fn
        self.core.net.eval()
        for p in self.params:
            p.grad = None
        total = 0.0
        B = images.shape[0]
        for b in range(B):
            loss = loss_fn(images[b], onehot[b], obj_valid[b]) / B
            loss.backward()
            self.weights.collect_grads()
            total += float(loss.detach())
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return total

    def update(self) -> None:
        """Adam on the masters' gradients, then the masters into the network."""
        self.opt.step()
        self.weights.copy_to_module()

    def train_step(self, images, onehot, obj_valid, windowed: bool = False) -> float:
        loss = self.loss_and_grads(images, onehot, obj_valid, windowed)
        self.update()
        return loss

    def fit(self, steps: int = 200, log_every: int = 50):
        last = None
        for i in range(steps):
            images, onehot, obj_valid = self._sample_batch()
            windowed = self.window_loss_fn is not None and self.rng.random() < self.window_mix
            last = self.train_step(images, onehot, obj_valid, windowed)
            if log_every and (i % log_every == 0):
                print(f"propagation step {i}: loss {last:.4f}")
        return last

    @torch.no_grad()
    def eval_propagation_iou(self, n_clips: int = 8) -> float:
        """Mean IoU of propagated masks against the ground truth on fresh clips."""
        h, w = self.core.image_size
        No = self.core.max_objects
        core, dev = self.core, self.core.device
        ious = []
        for _ in range(n_clips):
            images, masks = self.clip_fn(self.rng, self.clip_len, h, w, No)
            obj_valid = masks.sum((0, 2, 3)) > 0
            imgs = torch.from_numpy(images).to(dev)
            onehot0 = torch.from_numpy(masks[0]).to(dev)
            valid = torch.from_numpy(obj_valid).to(dev)
            if self.pyramid_fn is not None:
                pyr = self.pyramid_fn(imgs)
                keys, skips = core.encode_pyramid(*(pyr[k].permute(0, 3, 1, 2) for k in ("P3", "P4", "P5")))
                feats = [(keys[t], {k: v[t] for k, v in skips.items()}) for t in range(self.clip_len)]
                prob, mem, _ = core._incorporate_from_feats(core.memory, *feats[0], onehot0, valid)
            else:
                x = _chw(imgs).to(core.dtype)
                prob, mem, _ = core._incorporate_impl(core.memory, x[0], onehot0, valid)
            for t in range(1, self.clip_len):
                if self.pyramid_fn is not None:
                    prob, mem = core._step_from_feats(mem, *feats[t])
                else:
                    prob, mem = core._step_impl(mem, x[t])
                pred = prob.argmax(0).cpu().numpy()
                for o in range(No):
                    if not obj_valid[o]:
                        continue
                    p = pred == (o + 1)
                    g = masks[t, o] > 0.5
                    union = (p | g).sum()
                    if union:
                        ious.append((p & g).sum() / union)
        return float(np.mean(ious)) if ious else 0.0

