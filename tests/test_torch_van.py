"""The port's VAN (``models/van.py``) against the JAX package's.

The same seeded numpy variables (``tests/torch_parity.py seeded_jax_variables``:
LeCun kernels, non-trivial biases, scales and layer scales; for the whole model
``seeded_classifier_variables(family="van")``, BatchNorm statistics measured on
the seeded test images) go through the flax module and, carried across by
``export_classifier_state_dict``, through the port's.  fp32, TF32 off.

Limits: each module (LKA, attention, MLP, block, patch embed) 1e-5; ``van_b0``
at 64² 1e-4 in eval and in train mode, logits and the new BatchNorm statistics
(fp32 convolutions summed in another order through 13 blocks); the bf16 model
by ``tests/test_torch_bf16.py``'s rule (no farther from JAX fp32 than 1.5 × JAX
bf16) and at least half the JAX bf16 gap away from the port's own fp32 output.
The fine-tuner's step on VAN: ``tests/test_torch_van_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import VAN_PARAMS
from tests.torch_parity import classifier_images, seeded_classifier_variables, seeded_jax_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.models import van as jvan
from yolo_puncture_tpu_torch.models import van as pvan
from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier
from yolo_puncture_tpu_torch.registry import create_model
from yolo_puncture_tpu_torch.utils.convert import (
    classifier_flax_path_to_torch_key,
    export_classifier_state_dict,
    load_classifier_state_dict,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODULE_ATOL = 1e-5
MODEL_ATOL = 1e-4
PROB_ATOL = 1e-5
RULE = 1.5
S = 64


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (name, flax module, port module, input channels, forward kwargs of the flax module)
MODULES = [
    ("lka", jvan.LKA(24), pvan.LKA(24), 24, {}),
    ("attention", jvan.VanAttention(24), pvan.VanAttention(24), 24, {}),
    ("mlp", jvan.VanMlp(48, 24), pvan.VanMlp(48, 24), 24, {}),
    ("block", jvan.VanBlock(24, mlp_ratio=8), pvan.VanBlock(24, mlp_ratio=8), 24, {"train": False}),
    ("patch_embed_stem", jvan.OverlapPatchEmbed(16, patch=7, stride=4), pvan.OverlapPatchEmbed(3, 16, 7, 4), 3,
     {"train": False}),
    ("patch_embed", jvan.OverlapPatchEmbed(32, patch=3, stride=2), pvan.OverlapPatchEmbed(24, 32, 3, 2), 24,
     {"train": False}),
]


@pytest.mark.parametrize("name,jmod,pmod,cin,kw", MODULES, ids=[m[0] for m in MODULES])
def test_module_matches_flax(name, jmod, pmod, cin, kw):
    x = np.random.default_rng(len(name)).standard_normal((2, 29, 31, cin)).astype(np.float32)
    variables = seeded_jax_variables(jmod, jnp.asarray(x), seed=len(name))
    sd = export_classifier_state_dict(variables)
    pmod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=False)
    assert set(sd) == {k for k in pmod.state_dict() if not k.endswith("num_batches_tracked")}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), **kw))
    with torch.no_grad():
        got = _nhwc(pmod.eval()(_nchw(x)))
    assert got.shape == ref.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODULE_ATOL)


@functools.lru_cache(maxsize=None)
def _b0():
    """(JAX module, variables, port model) for ``van_b0`` at 64²."""
    variables = seeded_classifier_variables("b0", S, family="van")
    model = create_model("van_b0")
    load_classifier_state_dict(model, export_classifier_state_dict(variables))
    return jvan.VAN(variant="b0", num_classes=2), variables, model.eval()


def _x():
    return preprocess_classifier(torch.from_numpy(classifier_images(S)), S)


def test_van_b0_eval_matches_jax():
    jmodel, variables, model = _b0()
    x = _x()
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(_nhwc(x))))
    with torch.no_grad():
        got = model(x).numpy()
    assert np.abs(ref[1:] - ref[:1]).max() > 0.1  # the logits depend on the image
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_ATOL)


def test_van_b0_train_matches_jax():
    """Train mode: the logits on batch statistics and flax's update of every
    BatchNorm's running statistics (momentum 0.9, the biased variance)."""
    import copy

    jmodel, variables, model = _b0()
    model = copy.deepcopy(model)
    x = _x()
    ref, upd = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        got = model.train()(x).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=MODEL_ATOL)
    want = export_classifier_state_dict({"params": {}, "batch_stats": jax.device_get(upd["batch_stats"])})
    sd = model.state_dict()
    assert len(want) == 2 * 2 * 13 + 2 * 4
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=MODEL_ATOL, atol=MODEL_ATOL, err_msg=k)


@pytest.mark.parametrize("variant", list(jvan._CFG))
def test_parameter_count_matches_jax(variant):
    shapes = jax.eval_shape(jvan.VAN(variant=variant, num_classes=2).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = create_model(f"van_{variant}", num_classes=2)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert len(model.block3) == pvan._CFG[variant][1][2]
    assert VAN_PARAMS[f"van_{variant}"] == n_jax                   # chip_smoke.py's table, checked on the card
    if variant == "b0":
        assert n_jax == 3_849_314      # tests/test_classifiers.py: published VAN-B0 with a 2-class head


def test_classifier_net_matches_jax():
    """``ClassifierNet("van_b0")`` on both sides with the same variables: classes
    equal, probabilities within PROB_ATOL; through ``predict_images`` on crops of
    other sizes too (cv2's INTER_LINEAR on the JAX side, ``resize_linear_u8`` here)."""
    from yolo_puncture_tpu.tasks import classify as jcls
    from yolo_puncture_tpu_torch.tasks import ClassifierNet, predict_images

    _, variables, _ = _b0()
    jnet = jcls.ClassifierNet("van_b0", input_size=S)
    jnet.variables = variables
    net = ClassifierNet("van_b0", input_size=S, variables=variables, device="cpu")
    assert isinstance(net.model, pvan.VAN)
    images = classifier_images(S, n=8)
    j_idx, j_p = jnet.predict(images)
    idx, p = net.predict(images)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(p, j_p, rtol=0, atol=PROB_ATOL)
    assert len(set(np.round(j_p, 4))) > 1
    crops = [classifier_images(n, n=1)[0] for n in (48, 80)]
    (ji, jp), (gi, gp) = jcls.predict_images(jnet, crops), predict_images(net, crops)
    assert gi == ji and np.allclose(gp, jp, rtol=0, atol=PROB_ATOL)


def test_bf16_rule():
    """The bf16 model (bf16 convolutions and head, fp32 norms and layer scales):
    no farther from JAX fp32 than RULE × JAX bf16, and at least half the JAX bf16
    gap from the port's own fp32 logits (it does run in bf16)."""
    from yolo_puncture_tpu.models.efficientnet import preprocess_classifier as jax_preprocess

    _, variables, model32 = _b0()
    images = classifier_images(S, n=16)
    j32 = np.asarray(jax.jit(jvan.VAN(variant="b0", num_classes=2).apply)(
        variables, jax_preprocess(jnp.asarray(images), S, jnp.float32)))
    j16 = np.asarray(jax.jit(jvan.VAN(variant="b0", num_classes=2, dtype=jnp.bfloat16).apply)(
        variables, jax_preprocess(jnp.asarray(images), S, jnp.bfloat16)).astype(np.float32))
    model16 = create_model("van_b0", dtype=torch.bfloat16)
    load_classifier_state_dict(model16, export_classifier_state_dict(variables))
    assert model16.block1[0].layer_scale_1.dtype == torch.float32 and model16.norm1.weight.dtype == torch.float32
    with torch.no_grad():
        got16 = model16.eval()(preprocess_classifier(torch.from_numpy(images), S, torch.bfloat16))
        got32 = model32(preprocess_classifier(torch.from_numpy(images), S)).numpy()
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().numpy()
    e_jax, e_port = np.abs(j16 - j32).mean(), np.abs(got16 - j32).mean()
    assert 0 < e_jax and e_port <= RULE * e_jax, (e_port, e_jax)
    assert np.abs(got16 - got32).mean() >= 0.5 * e_jax


def test_published_keys_load_strictly(tmp_path):
    """The exported keys are the published VAN code's and cover the model exactly;
    a ``.pth.tar`` of them loads through ``ClassifierNet(checkpoint=...)`` to the
    same logits; a missing or an extra key is named in the error."""
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    _, variables, model = _b0()
    sd = export_classifier_state_dict(variables)
    for key in ("patch_embed1.proj.weight", "patch_embed1.norm.running_var", "block1.0.norm1.weight",
                "block1.0.attn.proj_1.weight", "block1.0.attn.spatial_gating_unit.conv0.weight",
                "block1.0.attn.spatial_gating_unit.conv_spatial.weight", "block1.0.attn.spatial_gating_unit.conv1.bias",
                "block1.0.attn.proj_2.bias", "block1.0.norm2.running_mean", "block1.0.mlp.fc1.weight",
                "block1.0.mlp.dwconv.dwconv.weight", "block1.0.mlp.fc2.weight", "block1.0.layer_scale_1",
                "block4.1.layer_scale_2", "norm4.weight", "norm4.bias", "head.weight", "head.bias"):
        assert key in sd, key
    assert sd["block1.0.mlp.dwconv.dwconv.weight"].shape == (256, 1, 3, 3)
    assert sd["block2.0.attn.spatial_gating_unit.conv_spatial.weight"].shape == (64, 1, 7, 7)
    assert sd["head.weight"].shape == (2, 256) and sd["block3.4.layer_scale_1"].shape == (160,)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(own) == set(sd)
    path = tmp_path / "van_b0.pth.tar"
    torch.save({"epoch": 3, "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    net = ClassifierNet("van_b0", checkpoint=str(path), input_size=S, device="cpu")
    x = _x()
    with torch.no_grad():
        np.testing.assert_array_equal(net.model(x).numpy(), model(x).numpy())
    fresh = create_model("van_b0")
    with pytest.raises(ValueError, match="mlp.dwconv.dwconv.weight"):
        load_classifier_state_dict(fresh, {k: v for k, v in sd.items() if k != "block2.1.mlp.dwconv.dwconv.weight"})
    with pytest.raises(ValueError, match="block1.0.mlp.dwconv.weight"):
        load_classifier_state_dict(fresh, {**sd, "block1.0.mlp.dwconv.weight": np.zeros(1, np.float32)})


def test_jax_converter_leaves_the_published_dwconv_key_unmatched():
    """An observation on the reference: the JAX package's
    ``convert_classifier_state_dict`` rewrites only ``.{digit}.`` segments, so a
    published VAN checkpoint's ``block{s}.{i}.mlp.dwconv.dwconv.*`` keys find no
    leaf (the flax module names the convolution ``mlp/dwconv``) and those kernels
    stay at their init; every other key is placed."""
    from yolo_puncture_tpu.utils.torch_convert import convert_classifier_state_dict

    jmodel, variables, _ = _b0()
    sd = export_classifier_state_dict(variables)
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3), jnp.float32))
    _, report = convert_classifier_state_dict(sd, template)
    dw = sorted(k for k in sd if ".mlp.dwconv.dwconv." in k)
    assert len(dw) == 2 * 13
    assert sorted(report["unmatched_torch_keys"]) == dw
    blocks = [f"block{s + 1}_{i}" for s, n in enumerate(jvan._CFG["b0"][1]) for i in range(n)]
    assert sorted(report["unfilled_flax_leaves"]) == sorted(
        (b, "mlp", "dwconv", leaf) for b in blocks for leaf in ("kernel", "bias"))


def test_key_map_of_every_leaf():
    """``classifier_flax_path_to_torch_key`` on VAN's and EfficientNet's paths."""
    assert classifier_flax_path_to_torch_key(("block3_11", "mlp", "dwconv"), "kernel") == \
        "block3.11.mlp.dwconv.dwconv.weight"
    assert classifier_flax_path_to_torch_key(("block1_0",), "layer_scale_2") == "block1.0.layer_scale_2"
    assert classifier_flax_path_to_torch_key(("norm2",), "scale") == "norm2.weight"
    assert classifier_flax_path_to_torch_key(("blocks_1_0", "bn3"), "mean") == "blocks.1.0.bn3.running_mean"
    assert classifier_flax_path_to_torch_key((), "layer_scale_1") == "layer_scale_1"
