"""The port's automatic mask generator, ``segment_anything`` and ``show_anns`` against the JAX package's.

One set of seeded weights (``tests/torch_parity.py seeded_sam_variables`` at a 64²
geometry, a 4×4 token grid, the hypernetworks' last layers scaled up and the IoU
head shifted so that the default thresholds keep masks) in both packages; a seeded 96×128 frame.  The
generator runs with ``points_per_side`` 2–4, loosened thresholds and
``crop_n_layers=1`` (five crops, each squashed to 64²): the same masks in the same
order, ``bbox``, ``crop_box`` and ``area`` equal, ``predicted_iou`` within the
decoder's 1e-3, and every segmentation pixel equal (none of the kept masks'
logits sits close enough to 0 for the two packages' rounding to flip it).
``segment_anything`` runs with both registries pointed at those weights, its
settings its own; ``show_anns`` draws the same pixels with ``np.random`` seeded
alike on both sides.
"""

import contextlib
import functools
import io
from unittest import mock

import numpy as np
import pytest
import torch

from tests.torch_parity import seeded_sam_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.models import sam as jsam
from yolo_puncture_tpu_torch.models import sam as psam
from yolo_puncture_tpu_torch.utils.convert import export_sam_state_dict, load_sam_state_dict

IMG = 64
IOU_TOL = 1e-3
HYPER_GAIN, IOU_SHIFT = 20.0, 0.3


@functools.lru_cache(maxsize=None)
def _variables():
    v = seeded_sam_variables(IMG, seed=11)
    dec = v["params"]["mask_decoder"]
    for i in range(4):          # mask logits of a few units, so that the default stability filter keeps some
        dec[f"hyper_{i}"]["layers_2"]["kernel"] *= HYPER_GAIN
    dec["iou_head"]["layers_2"]["bias"] += IOU_SHIFT
    return v


def _jax_sam(model_type="vit_b", checkpoint=None):
    return {"model": jsam.SAM(variant="vit_b", img_size=IMG), "variables": _variables(), "type": model_type,
            "img_size": IMG}


def _port_sam(model_type="vit_b", checkpoint=None, device=None):
    model = psam.SAM("vit_b", img_size=IMG)
    load_sam_state_dict(model, export_sam_state_dict(_variables()))
    return model.to(device or "cpu").eval()


def _frame():
    """A seeded 96×128 RGB frame: noise with two bright rectangles."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 120, (96, 128, 3), np.uint8)
    img[10:50, 20:70] = 230
    img[60:90, 80:120] = (40, 200, 90)
    return img


def _assert_same_masks(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g["bbox"] == [int(v) for v in r["bbox"]] and g["crop_box"] == [int(v) for v in r["crop_box"]]
        assert g["area"] == r["area"]
        assert abs(g["predicted_iou"] - r["predicted_iou"]) <= IOU_TOL
        assert g["segmentation"].dtype == bool and np.array_equal(g["segmentation"], r["segmentation"])
        assert g["stability_score"] == r["stability_score"] == 1.0


@pytest.mark.parametrize("pps,kw", [
    (2, dict(pred_iou_thresh=-10.0, stability_score_thresh=0.0)),
    (4, dict(pred_iou_thresh=0.6, stability_score_thresh=0.87, box_nms_thresh=0.95, points_per_batch=5)),
], ids=["pps2-all", "pps4-filtered"])
def test_generate_matches_jax(pps, kw):
    kw = {"points_per_batch": 4, "crop_n_layers": 1, "crop_n_points_downscale_factor": 2, **kw}
    ref = jsam.SamAutomaticMaskGenerator(_jax_sam(), points_per_side=pps, **kw).generate(_frame())
    gen = psam.SamAutomaticMaskGenerator(_port_sam(), points_per_side=pps, **kw)
    got = gen.generate(_frame())
    _assert_same_masks(got, ref)
    assert len({tuple(m["crop_box"]) for m in got}) > 1                   # masks from more than one crop
    assert gen.timer.counts["encode"] == 5                                # each crop encoded once


def test_segment_anything_and_show_anns_match_jax(capsys):
    """``segment_anything(frame)`` with its defaults (``vit_l``, 32 points a side,
    ``crop_n_layers=1``, downscale 2, the JAX thresholds) and no checkpoint on
    either side: the warning, the same masks; then ``show_anns`` over them."""
    from yolo_puncture_tpu.utils import sam_wrapper as jwrap
    from yolo_puncture_tpu_torch.utils import segment_anything, show_anns

    frame = _frame()
    with mock.patch.dict(jsam.sam_model_registry, {"vit_l": _jax_sam}):
        ref = jwrap.segment_anything(frame)
    jax_err = capsys.readouterr().err
    with mock.patch.dict(psam.sam_model_registry, {"vit_l": _port_sam}):
        got = segment_anything(frame, device="cpu")
    port_err = capsys.readouterr().err
    assert "WARNING: SAM checkpoint" in jax_err and "sam_vit_l.pth not found" in port_err
    assert "RANDOM weights" in port_err
    _assert_same_masks(got, ref)
    np.random.seed(3)
    want = jwrap.show_anns(frame.shape, ref, x_offset=2, y_offset=-1)
    np.random.seed(3)
    drawn = show_anns(frame.shape, got, x_offset=2, y_offset=-1)
    assert drawn.dtype == np.uint8 and np.array_equal(drawn, want) and drawn.any()
    assert np.array_equal(show_anns(frame.shape, []), jwrap.show_anns(frame.shape, []))


def test_segment_anything_needs_a_card_unless_asked(monkeypatch):
    from yolo_puncture_tpu_torch.utils import segment_anything

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(RuntimeError, match="device='cpu'"):
        segment_anything(_frame(), model_type="vit_b")
