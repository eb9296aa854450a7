"""Shared helpers for the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs and weights are made once with numpy from a seed and handed to both the
JAX reference and the port.  ``seeded_jax_variables`` fills the variable tree
of a flax module (shapes from ``jax.eval_shape``, so nothing is compiled) with
LeCun-scaled kernels, non-trivial biases and BatchNorm statistics: a wrong
layout, a missing flip or a swapped statistic then shows up in the outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One intra-op thread per test process: the suite runs several xdist
    workers at once, and torch's default of one thread per core each makes
    them spin against each other (a 0.5 s test took 20 s)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROTO_SOFT_ATOL = 1e-6  # soft masks: fp32 dot products of 32 terms summed in another order
PROTO_BAND = 1e-6       # binary masks may differ only where the soft value is this close to the threshold


def proto_decode_inputs(B, N, Hp, Wp, nm=32, seed=0):
    """protos (B, Hp, Wp, nm) in the JAX layout, coeffs (B, N, nm), boxes (B, N, 4)
    xyxy in proto pixels, every other instance on integer coordinates (the edges
    of the half-open box test)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((B, Hp, Wp, nm)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((B, N, nm))).astype(np.float32)
    x1 = rng.uniform(-2, Wp * 0.6, (B, N))
    y1 = rng.uniform(-2, Hp * 0.6, (B, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, Wp, (B, N)), y1 + rng.uniform(1, Hp, (B, N))], -1)
    boxes[:, ::2] = np.round(boxes[:, ::2])
    return protos, coeffs, boxes.astype(np.float32)


def assert_masks_match(got, ref, soft_ref, threshold):
    """Soft masks within PROTO_SOFT_ATOL; binary masks equal away from the threshold."""
    if threshold is None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=PROTO_SOFT_ATOL)
    else:
        assert set(np.unique(got)) <= {0.0, 1.0}
        differ = got != ref
        assert not (differ & (np.abs(soft_ref - threshold) > PROTO_BAND)).any()


def seeded_jax_variables(module, example, seed: int = 0):
    """numpy variable tree ({'params', 'batch_stats'}) for ``module`` applied to
    ``example`` (a jnp array), drawn from ``numpy.random.default_rng(seed)``."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), example)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.uniform(0.0, 1.0, shape)).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def classifier_images(size: int, n: int = 6) -> np.ndarray:
    """Seeded RGB uint8 images (n, size, size, 3); every other one black below
    and right of a random corner, as the zero-padded crops at a frame's edge are."""
    rng = np.random.default_rng(size)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    for im in images[1::2]:
        y, x = rng.integers(size // 4, size, 2)
        im[y:] = 0
        im[:, x:] = 0
    return images


def calibrated_batch_stats(variables, model, inputs, key_of):
    """``variables`` with every BatchNorm's statistics replaced by those of
    ``inputs``, measured by ``model`` (the port's counterpart, loaded from
    ``variables``) in train mode.  ``key_of(path, leaf)`` maps a flax variable
    to the port's state-dict key.  With the seeded statistics alone the
    activations of a deep network fade through the layers until every input
    gives the same outputs; with the inputs' own every layer stays near unit
    scale and the outputs differ from input to input."""
    import jax

    from yolo_puncture_tpu_torch.nn.common import torch_batch_statistics

    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad(), torch_batch_statistics(model):
        model.train()(inputs)
    model.eval()
    sd = model.state_dict()

    def stat(path, leaf):
        names = tuple(p.key for p in path)
        return sd[key_of(names[:-1], names[-1])].numpy()

    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def seeded_classifier_variables(variant: str, size: int, seed: int = 3):
    """numpy variable tree of the JAX package's ``EfficientNet(variant)`` with
    two classes: ``seeded_jax_variables`` with the BatchNorm statistics of
    ``classifier_images(size)`` (``calibrated_batch_stats``)."""
    import jax.numpy as jnp

    from yolo_puncture_tpu.models.efficientnet import EfficientNet
    from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
    from yolo_puncture_tpu_torch.registry import create_model
    from yolo_puncture_tpu_torch.utils.convert import (
        _FLAX_BLOCK,
        _LEAF,
        export_classifier_state_dict,
        load_classifier_state_dict,
    )

    variables = seeded_jax_variables(EfficientNet(variant=variant, num_classes=2),
                                     jnp.zeros((1, size, size, 3), jnp.float32), seed)
    model = create_model(f"efficientnet_{variant}")
    load_classifier_state_dict(model, export_classifier_state_dict(variables))

    def key_of(path, leaf):
        return _FLAX_BLOCK.sub(lambda m: f"blocks.{m.group(1)}.{m.group(2)}.", ".".join(path) + ".") + _LEAF[leaf]

    images = preprocess_classifier(torch.from_numpy(classifier_images(size)), size)
    return calibrated_batch_stats(variables, model, images, key_of)


def unet_images(h: int, w: int, n: int = 3, seed: int = 5) -> np.ndarray:
    """Seeded BGR uint8 frames (n, h, w, 3): a bright slanted bar over dark
    noise, the needle crops the app hands to U²-Net."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 90, (n, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for i, im in enumerate(images):
        im[np.abs(yy - (0.3 + 0.1 * i) * h - 0.4 * xx) < 4 + i] = 220
    return images


def seeded_u2net_variables(small: bool, images_bgr: np.ndarray, seed: int = 7):
    """numpy variable tree of the JAX package's ``U2Net(small)``:
    ``seeded_jax_variables`` with the BatchNorm statistics of ``images_bgr``
    (``calibrated_batch_stats``)."""
    import jax.numpy as jnp

    from yolo_puncture_tpu.models.u2net import U2Net as JaxU2Net
    from yolo_puncture_tpu_torch.models.u2net import U2Net
    from yolo_puncture_tpu_torch.utils.convert import _LEAF, export_u2net_state_dict

    h, w = images_bgr.shape[1:3]
    variables = seeded_jax_variables(JaxU2Net(small=small), jnp.zeros((1, h, w, 3), jnp.float32), seed)
    model = U2Net(small=small)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in export_u2net_state_dict(variables).items()},
                          strict=False)
    x = torch.from_numpy(images_bgr[..., ::-1].copy()).permute(0, 3, 1, 2).float() / 255.0
    return calibrated_batch_stats(variables, model, x, lambda path, leaf: ".".join(path) + "." + _LEAF[leaf])


def seeded_detector_variables(version: str, frames_bgr: np.ndarray, imgsz: int, seed: int = 11):
    """numpy variable tree of the JAX package's YOLO ``version``-n seg with one
    class: ``seeded_jax_variables`` with the BatchNorm statistics of
    ``frames_bgr`` letterboxed to ``imgsz`` (``calibrated_batch_stats``), so
    that the best score differs from frame to frame."""
    import jax.numpy as jnp

    from yolo_puncture_tpu.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.ops.letterbox import letterbox
    from yolo_puncture_tpu_torch.utils.convert import yolo_flax_path_to_torch_key

    variables = seeded_jax_variables(YOLOModel(version=version, scale="n", nc=1, task="segment"),
                                     jnp.zeros((1, imgsz, imgsz, 3)), seed)
    model = port_model_from_jax(version, "n", 1, "segment", variables)
    images, _, _ = letterbox(torch.from_numpy(frames_bgr), imgsz, bgr_to_rgb=True)
    return calibrated_batch_stats(variables, model, images, yolo_flax_path_to_torch_key)


def port_model_from_jax(version, scale, nc, task, variables):
    """The port's YOLOModel on the CPU, loaded from JAX variables through the bridge."""
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

    model = YOLOModel(version, scale, nc, task)
    load_yolo_state_dict(model, export_yolo_state_dict(variables))
    return model.eval()


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------

NEEDLE_CHECKPOINT = "resources/weights/tracker_propagation_needle.msgpack"
SHARED_CHECKPOINT = "resources/weights/tracker_shared.msgpack"


def repo_path(rel: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), rel)


def seeded_tracker_variables(seed: int = 0, image_hw=(32, 64), with_pyramid_adapter: bool = False):
    """numpy variable tree of the JAX ``PropagationNetwork`` drawn from ``seed``."""
    import jax.numpy as jnp

    from yolo_puncture_tpu.track.network import PropagationNetwork

    net = PropagationNetwork(with_pyramid_adapter=with_pyramid_adapter)
    return seeded_jax_variables(net, jnp.zeros((1, *image_hw, 3), jnp.float32), seed)


def port_tracker_network(variables, **kw):
    """The port's ``PropagationNetwork`` on the CPU, loaded from a JAX variable tree."""
    from yolo_puncture_tpu_torch.track.network import PropagationNetwork
    from yolo_puncture_tpu_torch.utils.convert import export_tracker_state_dict, load_tracker_state_dict

    net = PropagationNetwork(**kw)
    load_tracker_state_dict(net, export_tracker_state_dict(variables))
    return net.eval()


def to_nchw(a) -> torch.Tensor:
    """numpy (…, H, W, C) → torch (…, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    """torch (…, C, H, W) → numpy (…, H, W, C)."""
    return np.moveaxis(t.detach().numpy(), -3, -1)


def bar_clip(n: int, h: int, w: int, seed: int = 0):
    """uint8 RGB frames of a bright bar moving right over noise, and the first
    frame's id mask (the bar is id 1)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3)).astype(np.uint8)
    y0, bh, bw = h // 3, max(h // 5, 4), w // 3
    for i in range(n):
        x0 = w // 8 + 2 * i
        frames[i, y0:y0 + bh, x0:x0 + bw] = 230
    mask = np.zeros((h, w), np.int32)
    mask[y0:y0 + bh, w // 8:w // 8 + bw] = 1
    return frames, mask


def write_seg_dataset(root, n_train=5, n_val=2, seed=0):
    """A YOLO-format dataset of PNG files: bright polygons on noise, 1–3 a frame,
    frames of a few sizes, one train frame without a label file."""
    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = (48, 80) if i % 2 else (72, 60)
            img = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
            lines = []
            for _ in range(int(rng.integers(1, 4))):
                cx, cy = rng.uniform(0.2, 0.8, 2)
                r = rng.uniform(0.1, 0.25)
                ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
                poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).clip(0, 1)
                cv2.fillPoly(img, [np.round(poly * [w, h]).astype(np.int32)], (200, 220, 240))
                lines.append("0 " + " ".join(f"{v:.5f}" for v in poly.reshape(-1)))
            cv2.imwrite(str(root / "images" / split / f"f{i}.png"), img)
            if not (split == "train" and i == n - 1):
                (root / "labels" / split / f"f{i}.txt").write_text("\n".join(lines) + "\n")
    return root
