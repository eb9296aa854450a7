"""The port on the card: each CUDA kernel against its plain PyTorch version, and
``YOLO.predict`` on ``cuda`` against the same predictor on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch (the repository's ``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

# imported by its own name (pytest puts tests/ on sys.path): a machine may have
# another distribution's top-level ``tests`` package installed, which would shadow
# ``tests.torch_parity``
from torch_parity import assert_masks_match, proto_decode_inputs
from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode, proto_decode_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 32, 160, 160), (3, 37, 100, 168), (2, 70, 33, 45)])
@pytest.mark.parametrize("threshold", [None, 0.5])
@pytest.mark.parametrize("crop", [True, False])
def test_proto_decode_kernel_matches_plain_version(cuda, shape, threshold, crop):
    B, N, Hp, Wp = shape
    protos, coeffs, boxes = proto_decode_inputs(B, N, Hp, Wp, seed=7)
    p = torch.from_numpy(protos).permute(0, 3, 1, 2).contiguous().to(cuda)
    c, b = torch.from_numpy(coeffs).to(cuda), torch.from_numpy(boxes).to(cuda)
    before = proto_decode.launches
    got = proto_decode(p, c, b, threshold, crop)
    torch.cuda.synchronize()
    assert proto_decode.launches == before + 1
    ref = proto_decode_reference(p, c, b, threshold, crop)
    soft = proto_decode_reference(p, c, b, None, crop)
    assert_masks_match(got.cpu().numpy(), ref.cpu().numpy(), soft.cpu().numpy(), threshold)


@pytest.mark.gpu
def test_proto_decode_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(1, 32, 8, 8, device=cuda)
    c, b = torch.zeros(1, 2, 32, device=cuda), torch.zeros(1, 2, 4, device=cuda)
    with pytest.raises(TypeError):
        proto_decode(p.double(), c.double(), b.double())
    with pytest.raises(ValueError):
        proto_decode(p.transpose(2, 3), c, b)
    with pytest.raises(ValueError):
        proto_decode(torch.zeros(1, 16, 8, 8, device=cuda), torch.zeros(1, 2, 16, device=cuda), b)


@pytest.mark.gpu
@pytest.mark.parametrize("retina", [False, True])
def test_predict_on_the_card_matches_the_cpu(cuda, retina):
    from yolo_puncture_tpu_torch import YOLO

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (2, 96, 160, 3)).astype(np.uint8)
    frames[:, 20:60, 30:120] += 150
    kw = dict(conf=0.0, imgsz=64, retina_masks=retina)
    gpu_det = YOLO("yolo10n-seg", nc=1, max_det=20, max_masks=4, seed=1)
    before = proto_decode.launches
    got = gpu_det.predict(list(frames), **kw)
    assert proto_decode.launches > before
    ref = YOLO("yolo10n-seg", nc=1, max_det=20, max_masks=4, seed=1, device="cpu").predict(list(frames), **kw)
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        for i in range(len(g)):  # near-equal scores may come in another order: match by value
            j = int(np.argmin(np.abs(r.boxes.xyxy - g.boxes.xyxy[i]).max(1)
                              + 1e3 * np.abs(r.boxes.conf - g.boxes.conf[i])))
            assert g.boxes.cls[i] == r.boxes.cls[j]
            np.testing.assert_allclose(g.boxes.xyxy[i], r.boxes.xyxy[j], rtol=0, atol=1e-2)
            np.testing.assert_allclose(g.boxes.conf[i], r.boxes.conf[j], rtol=0, atol=1e-4)
            assert (g.masks.data[i] == r.masks.data[j]).mean() >= 0.999
