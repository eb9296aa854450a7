"""The port's U²-Net (``models/u2net.py``) and its task (``tasks/unet.py``)
against the JAX package's, on the CPU.

Both networks get the same seeded variables (``tests/torch_parity.py
seeded_u2net_variables``: BatchNorm statistics measured on the test images),
the port's through ``utils/convert.py export_u2net_state_dict``.  The input is
70×90, so that ceil-mode pooling (70 → 35 → 18 → 9 → 5 → 3) and bilinear
up-sampling at non-integer ratios occur.

Tolerances: in float64 on both sides (the JAX network under
``jax.enable_x64`` with ``dtype=float64``, the port's cast with ``double``)
all seven sigmoid maps within 1e-9: the same network and the same resize
(``ops/resize.py resize_bilinear`` takes its scales and weights in float64 for
float64 images, as ``jax.image.resize`` does with 64-bit floats).  In fp32, as the app runs it, within
FP32_MAP_TOL: the calibrated activations reach about 10, and fp32
convolutions summed in another order through some 150 layers move them, so
each package's fp32 network is up to 1.8e-4 from the float64 forward of the
same network (full U²-Net, d1; U2NETP 9.5e-5) and the two may be twice that
apart (measured 1.7e-4).  ``UNetPredictor.predict``'s masks (the fused map
min-max normalised and thresholded at 0.5) equal wherever the normalised
value is farther than MASK_BAND from 0.5, and at least 99.9 % of the pixels
equal overall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import seeded_u2net_variables, unet_images
from yolo_puncture_tpu.models.u2net import U2Net as JaxU2Net
from yolo_puncture_tpu.models.u2net import norm_pred as jax_norm_pred
from yolo_puncture_tpu_torch.models.u2net import U2Net
from yolo_puncture_tpu_torch.utils.convert import export_u2net_state_dict

H, W = 70, 90
FP64_MAP_TOL = 1e-9
FP32_MAP_TOL = 4e-4
MASK_BAND = 1e-3
MASK_AGREE = 0.999


def _port(small, variables):
    model = U2Net(small=small)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in export_u2net_state_dict(variables).items()},
                          strict=False)
    return model.eval()


@pytest.fixture(scope="module", params=[True, False], ids=["u2netp", "u2net"])
def nets(request):
    small = request.param
    images = unet_images(H, W)
    variables = seeded_u2net_variables(small, images)
    return small, images, variables


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_seven_maps_match_jax(nets, precision):
    small, images, variables = nets
    x = images[..., ::-1] / 255.0
    model = _port(small, variables)
    if precision == "float64":
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
            ref = [np.asarray(r) for r in JaxU2Net(small=small, dtype=jnp.float64).apply(v64, jnp.asarray(x))]
        model, tol = model.double(), FP64_MAP_TOL
    else:
        x = x.astype(np.float32)
        ref = [np.asarray(r) for r in JaxU2Net(small=small).apply(variables, jnp.asarray(x))]
        tol = FP32_MAP_TOL
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 7
    spread = float(ref[0].std())
    assert spread > 0.05, spread                  # the calibrated statistics keep the fused map alive
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.dtype == r.dtype == np.dtype(precision) and g.shape == r.shape == (len(images), H, W, 1), i
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=f"map d{i}")


def test_exported_state_dict_has_the_reference_names(nets):
    small, _, variables = nets
    sd = export_u2net_state_dict(variables)
    model_keys = {k for k in U2Net(small=small).state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == model_keys
    for k in ("stage1.rebnconvin.conv_s1.weight", "stage1.rebnconv7.bn_s1.running_var",
              "stage1d.rebnconv1d.conv_s1.bias", "stage4.rebnconv3d.bn_s1.weight", "stage5.rebnconv4.conv_s1.weight",
              "stage6.rebnconv3d.bn_s1.running_mean", "side1.weight", "side6.bias", "outconv.weight"):
        assert k in sd, k
    assert sd["stage2.rebnconv6.conv_s1.weight"].shape == ((16 if small else 32),) * 2 + (3, 3)
    assert sd["outconv.weight"].shape == (1, 6, 1, 1)


def test_unet_predictor_matches_jax(nets, tmp_path):
    """``UNetPredictor`` of both packages from the same torch-named ``.pth`` file."""
    from yolo_puncture_tpu.tasks.unet import UNetPredictor as JaxUNetPredictor
    from yolo_puncture_tpu_torch.tasks import UNetPredictor, unet_predict

    small, images, variables = nets
    name = "u2netp" if small else "u2net"
    path = str(tmp_path / f"{name}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in export_u2net_state_dict(variables).items()}, path)
    jax_pred = JaxUNetPredictor(name, checkpoint=path)
    port_pred = UNetPredictor(name, checkpoint=path, device="cpu")
    x = (images[..., ::-1] / 255.0).astype(np.float32)
    soft = np.asarray(JaxU2Net(small=small).apply(variables, jnp.asarray(x))[0])[..., 0]
    for img, s in zip(images, soft):
        ref, got = jax_pred.predict(img), unet_predict(port_pred, img)
        assert got.dtype == np.uint8 and got.shape == (H, W) and set(np.unique(got)) <= {0, 255}
        assert 0 < (ref > 0).mean() < 1                            # a mask with both sides
        near = np.abs(np.asarray(jax_norm_pred(jnp.asarray(s))) - 0.5) <= MASK_BAND
        assert not ((got != ref) & ~near).any()
        assert (got == ref).mean() >= MASK_AGREE


def test_checkpoint_that_does_not_fit_raises(tmp_path):
    from yolo_puncture_tpu_torch.tasks import UNetPredictor

    sd = U2Net(small=True).state_dict()
    sd.pop("outconv.bias")
    path = str(tmp_path / "u2netp.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="outconv.bias"):
        UNetPredictor("u2netp", checkpoint=path, device="cpu")
