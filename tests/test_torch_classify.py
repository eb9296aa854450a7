"""The port's classifier task against the JAX package's, on the same variables
(``tests/torch_parity.py seeded_classifier_variables``, B0 at 96²): classes
equal, probabilities within 1e-5.

``predict_images`` resizes crops of other sizes with cv2 in the JAX package and
with the port's cv2 arithmetic (``ops/resize.py``) in the port: the same pixels.
``predict_and_find_start_inserted`` crops around each box, classifies in
batches (the JAX package pads the last one) and runs the key-frame search.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import classifier_images, seeded_classifier_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.tasks import classify as jcls
from yolo_puncture_tpu_torch.tasks import classify as pcls

PROB_ATOL = 1e-5
SIZE = 96


@pytest.fixture(scope="module")
def nets():
    variables = seeded_classifier_variables("b0", SIZE, seed=7)  # a seed under which both classes occur
    jnet = jcls.ClassifierNet("efficientnet_b0", input_size=SIZE)
    jnet.variables = variables
    pnet = pcls.ClassifierNet("efficientnet_b0", input_size=SIZE, variables=variables, device="cpu")
    return jnet, pnet


def test_predict_matches_jax(nets):
    jnet, pnet = nets
    images = classifier_images(SIZE)
    idx, p = pnet.predict(images)
    ref_idx, ref_p = jnet.predict(images)
    assert len(set(idx.tolist())) == 2  # both classes occur
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(p, ref_p, rtol=0, atol=PROB_ATOL)


def test_predict_images_resizes_like_cv2(nets):
    jnet, pnet = nets
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((96, 96), (120, 80), (48, 48), (192, 192), (61, 130))]
    idx, p = pcls.predict_images(pnet, images)
    ref_idx, ref_p = jcls.predict_images(jnet, images)
    assert idx == ref_idx
    np.testing.assert_allclose(p, ref_p, rtol=0, atol=PROB_ATOL)


def test_predict_and_find_start_inserted_matches_jax(nets):
    jnet, pnet = nets
    rng = np.random.default_rng(8)
    frames = list(rng.integers(0, 256, (21, 80, 150, 3), dtype=np.uint8))
    boxes = [(float(x), float(y), float(x) + 30.5, float(y) + 12.25)
             for x, y in zip(rng.uniform(-10, 140, 21), rng.uniform(-10, 70, 21))]
    got = pcls.predict_and_find_start_inserted(pnet, frames, boxes, judge_wnd=5, batch_size=8)
    ref = jcls.predict_and_find_start_inserted(jnet, frames, boxes, judge_wnd=5, batch_size=8)
    assert got[0] == ref[0] and got[2] == ref[2]
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=PROB_ATOL)
    assert pcls.predict_and_find_start_inserted(pnet, [], []) == ([], [], 0)
    with pytest.raises(ValueError):
        pcls.predict_and_find_start_inserted(pnet, frames[:2], boxes[:1])


def test_classifier_net_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcls.ClassifierNet("efficientnet_b0", input_size=SIZE)
    net = pcls.load_classify_net(name="efficientnet_b0", input_size=SIZE, device="cpu", seed=1)
    idx, p = net.predict(classifier_images(SIZE, n=3))
    assert idx.shape == (3,) and ((p >= 0.5) & (p <= 1.0)).all()
