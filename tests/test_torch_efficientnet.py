"""The port's EfficientNet and its preprocessing against the JAX package.

The same seeded numpy variables (``tests/torch_parity.py
seeded_classifier_variables``: LeCun kernels, non-trivial biases and scales,
BatchNorm statistics of the seeded test images, so that the logits differ from
image to image) go through the JAX forward and, carried across by
``export_classifier_state_dict``, through the port's; B3 has its published
widths and depth.  fp32, TF32 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import classifier_images, seeded_classifier_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.models import efficientnet as jeff
from yolo_puncture_tpu_torch.models import efficientnet as peff
from yolo_puncture_tpu_torch.registry import create_model
from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict, load_classifier_state_dict

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOGIT_ATOL = 1e-4      # fp32 convolutions summed in another order, through 26 blocks (B3)
PREPROCESS_ATOL = 1e-5


@pytest.fixture(scope="module", params=[("b0", 96), ("b3", 64)], ids=["b0-96", "b3-64"])
def pair(request):
    """(variant, size, JAX module, JAX variables, port model loaded from them)."""
    variant, size = request.param
    jmodel = jeff.EfficientNet(variant=variant, num_classes=2)
    variables = seeded_classifier_variables(variant, size)
    model = create_model(f"efficientnet_{variant}", num_classes=2)
    load_classifier_state_dict(model, export_classifier_state_dict(variables))
    return variant, size, jmodel, variables, model.eval()


def test_forward_matches_jax(pair):
    variant, size, jmodel, variables, model = pair
    x = peff.preprocess_classifier(torch.from_numpy(classifier_images(size)), size)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
    with torch.no_grad():
        got = model(x).numpy()
    assert np.abs(ref[1:] - ref[:1]).max() > 0.1  # the logits depend on the image
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)


def test_parameter_count_matches_jax(pair):
    variant, _, _, variables, model = pair
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if variant == "b3":
        # torchvision publishes 12,233,232 for B3 with its 1000-class head (1536 × 1000 + 1000)
        assert n_jax == 12_233_232 - 1536 * 1000 - 1000 + 1536 * 2 + 2


@pytest.mark.parametrize("hw", [(64, 64), (50, 70), (150, 110)], ids=["no-resize", "up", "down"])
def test_preprocess_matches_jax(hw):
    images = np.random.default_rng(sum(hw)).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    ref = np.asarray(jeff.preprocess_classifier(jnp.asarray(images), 64))
    got = peff.preprocess_classifier(torch.from_numpy(images), 64)
    assert tuple(got.shape) == (2, 3, 64, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=PREPROCESS_ATOL)


def test_state_dict_round_trip_by_timm_keys(pair, tmp_path):
    """The exported keys are timm's and cover the model exactly; a timm-style
    checkpoint file loads through ``ClassifierNet(checkpoint=...)`` to the same logits;
    a missing or an extra key is named in the error."""
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    variant, size, _, variables, model = pair
    sd = export_classifier_state_dict(variables)
    for key in ("conv_stem.weight", "bn1.running_var", "blocks.0.0.conv_dw.weight", "blocks.0.0.se.conv_reduce.bias",
                "blocks.1.0.conv_pwl.weight", "blocks.1.0.bn3.running_mean", "conv_head.weight", "classifier.weight"):
        assert key in sd, key
    assert sd["blocks.1.0.conv_dw.weight"].shape[1:] == (1, 3, 3)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(own) == set(sd)
    for k, v in own.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)

    path = tmp_path / f"efficientnet_{variant}.pth.tar"
    torch.save({"epoch": 3, "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    net = ClassifierNet(f"efficientnet_{variant}", checkpoint=str(path), input_size=size, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, size, size)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(net.model(x).numpy(), model(x).numpy())

    fresh = create_model(f"efficientnet_{variant}")
    with pytest.raises(ValueError, match="conv_head.weight"):
        load_classifier_state_dict(fresh, {k: v for k, v in sd.items() if k != "conv_head.weight"})
    with pytest.raises(ValueError, match="blocks.0.0.extra"):
        load_classifier_state_dict(fresh, {**sd, "blocks.0.0.extra": np.zeros(1, np.float32)})
