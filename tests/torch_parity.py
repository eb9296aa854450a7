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
