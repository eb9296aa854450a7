"""Detection selection of the PyTorch port against the JAX package.

Indices, classes, counts and validity masks must be identical; box and score
values agree to 1e-6.  Ties are planted so that the tie-break (lowest index
first, as ``lax.top_k``) is exercised on both the k <= 32 and the k > 32 path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.ops import nms as jnms
from yolo_puncture_tpu_torch.ops import nms as pnms

EXACT = ("classes", "indices", "valid", "count")


def _compare(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(g.astype(np.int64), r.astype(np.int64), err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=k)


def _head(B, A, nc, seed, ties=True, nm=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (B, A, 2))
    wh = rng.uniform(2, 30, (B, A, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    if ties:  # equal scores at many (anchor, class) slots
        probs[:, ::5, 0] = 0.75
        probs[:, 1::7, -1] = 0.75
        probs[:, 3::11, :] = 0.5
    out = {"boxes": boxes, "probs": probs}
    if nm:
        out["coeffs"] = rng.standard_normal((B, A, nm)).astype(np.float32)
    return out


@pytest.mark.parametrize("max_det", [8, 32, 40, 300])
@pytest.mark.parametrize("conf", [0.0, 0.6])
def test_v10_topk_select_matches_jax(max_det, conf):
    h = _head(2, 60, 3, seed=max_det)
    ref = jnms.v10_topk_select(jnp.asarray(h["boxes"]), jnp.asarray(h["probs"]), conf, max_det)
    got = pnms.v10_topk_select(torch.from_numpy(h["boxes"]), torch.from_numpy(h["probs"]), conf, max_det)
    _compare(got, ref)


@pytest.mark.parametrize("class_agnostic", [False, True])
@pytest.mark.parametrize("conf,iou,max_det", [(0.0, 0.7, 20), (0.3, 0.5, 300), (0.5, 0.3, 10)])
def test_batched_nms_matches_jax(class_agnostic, conf, iou, max_det):
    h = _head(2, 80, 3, seed=int(conf * 10) + max_det, ties=False)
    ref = jnms.batched_nms(jnp.asarray(h["boxes"]), jnp.asarray(h["probs"]), conf, iou, max_det,
                           class_agnostic)
    got = pnms.batched_nms(torch.from_numpy(h["boxes"]), torch.from_numpy(h["probs"]), conf, iou,
                           max_det, class_agnostic)
    _compare(got, ref)


@pytest.mark.parametrize("nms_free", [True, False])
def test_select_detections_gathers_coeffs_like_jax(nms_free):
    h = _head(2, 50, 2, seed=5, ties=nms_free, nm=8)
    ref = jnms.select_detections({k: jnp.asarray(v) for k, v in h.items()}, nms_free, 0.4, 0.6, 16)
    got = pnms.select_detections({k: torch.from_numpy(v) for k, v in h.items()}, nms_free, 0.4, 0.6, 16)
    _compare(got, ref)


def test_box_iou_matches_jax():
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 50, (6, 2, 2)), axis=1).transpose(0, 2, 1).reshape(6, 4)[:, [0, 2, 1, 3]]
    b = np.sort(rng.uniform(0, 50, (5, 2, 2)), axis=1).transpose(0, 2, 1).reshape(5, 4)[:, [0, 2, 1, 3]]
    a, b = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_allclose(pnms.box_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jnms.box_iou_xyxy(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
