"""Blocks, heads and the full YOLO forward of the PyTorch port against the JAX package.

Each case builds the flax module and the port's module, fills the flax
variables from a numpy seed (``tests/torch_parity.py``), carries them over
with the port's weight bridge, and compares outputs at fp32 with rtol/atol 1e-4:
convolutions sum in another order on the two sides.  Inputs are NHWC on the
JAX side and NCHW inside the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import port_model_from_jax, seeded_jax_variables, torch_single_thread  # noqa: F401
from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
from yolo_puncture_tpu.nn import common as jc
from yolo_puncture_tpu.utils.torch_convert import export_yolo_state_dict as jax_export
from yolo_puncture_tpu_torch.nn import common as pc
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)

# name → (flax module, port module, input channels, H, W)
BLOCKS = {
    "ConvBN": (lambda: jc.ConvBN(16, 3, 2), lambda: pc.ConvBN(8, 16, 3, 2), 8, 9, 12),
    "DWConv": (lambda: jc.DWConv(8, 3, 1), lambda: pc.DWConv(8, 8, 3, 1), 8, 8, 8),
    "Bottleneck": (lambda: jc.Bottleneck(8, True), lambda: pc.Bottleneck(8, 8, True), 8, 8, 8),
    "C2f": (lambda: jc.C2f(16, 2, True), lambda: pc.C2f(8, 16, 2, True), 8, 8, 8),
    "C3": (lambda: jc.C3(16, 2, True), lambda: pc.C3(8, 16, 2, True), 8, 8, 8),
    "C3k": (lambda: jc.C3k(16, 2, True, kernel=3), lambda: pc.C3k(8, 16, 2, True, k=3), 8, 8, 8),
    "C3k2-c3k": (lambda: jc.C3k2(16, 1, True), lambda: pc.C3k2(8, 16, 1, True), 8, 8, 8),
    "C3k2-bottleneck": (lambda: jc.C3k2(16, 2, False, 0.25), lambda: pc.C3k2(8, 16, 2, False, 0.25),
                        8, 8, 8),
    "SPPF": (lambda: jc.SPPF(16, 5), lambda: pc.SPPF(16, 16, 5), 16, 7, 9),
    "SCDown": (lambda: jc.SCDown(16, 3, 2), lambda: pc.SCDown(8, 16, 3, 2), 8, 9, 8),
    "RepVGGDW": (lambda: jc.RepVGGDW(8), lambda: pc.RepVGGDW(8), 8, 9, 9),
    "CIB": (lambda: jc.CIB(8, True), lambda: pc.CIB(8, 8, True), 8, 8, 8),
    "CIB-lk": (lambda: jc.CIB(8, True, lk=True), lambda: pc.CIB(8, 8, True, lk=True), 8, 8, 8),
    "C2fCIB": (lambda: jc.C2fCIB(16, 1, True, lk=True), lambda: pc.C2fCIB(8, 16, 1, True, True),
               8, 8, 8),
    "Attention": (lambda: jc.Attention(64, 2, 0.5), lambda: pc.Attention(64, 2, 0.5), 64, 4, 5),
    "PSABlock": (lambda: jc.PSABlock(64, 0.5, 1), lambda: pc.PSABlock(64, 0.5, 1), 64, 4, 4),
    "PSA": (lambda: jc.PSA(128), lambda: pc.PSA(128, 128), 128, 4, 4),
    "C2PSA": (lambda: jc.C2PSA(128, 1), lambda: pc.C2PSA(128, 128, 1), 128, 3, 4),
    "Proto": (lambda: jc.Proto(16, 32), lambda: pc.Proto(8, 16, 32), 8, 5, 6),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jax_ctor, port_ctor, cin, H, W = BLOCKS[name]
    x = np.random.default_rng(1).standard_normal((2, H, W, cin)).astype(np.float32)
    jm = jax_ctor()
    variables = seeded_jax_variables(jm, jnp.asarray(x), seed=len(name))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    pm = port_ctor().eval()
    sd = export_yolo_state_dict(variables)
    if name == "DWConv":  # the flax DWConv nests its ConvBN as 'dw'; ultralytics' is a Conv
        sd = {k.removeprefix("dw."): v for k, v in sd.items()}
    load_yolo_state_dict(pm, sd)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_functional_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(pc.upsample_nearest_2x(xt).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jc.upsample_nearest_2x(jnp.asarray(x))))
    for k in (3, 5):
        np.testing.assert_array_equal(pc.max_pool_same(xt, k).permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jc.max_pool_same(jnp.asarray(x), k)))
    d = (3 * rng.standard_normal((2, 9, 64))).astype(np.float32)
    np.testing.assert_allclose(pc.dfl_expectation(torch.from_numpy(d)).numpy(),
                               np.asarray(jc.dfl_expectation(jnp.asarray(d))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("xywh", [False, True])
def test_anchors_and_dist2bbox_match_jax(xywh):
    from yolo_puncture_tpu.nn import heads as jh
    from yolo_puncture_tpu_torch.nn import heads as ph

    shapes, strides = [(4, 6), (2, 3), (1, 2)], [8, 16, 32]
    pa, ps = ph.make_anchors(shapes, strides)
    ja, js = jh.make_anchors(shapes, strides)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    d = np.random.default_rng(8).uniform(0, 5, (2, pa.shape[0], 4)).astype(np.float32)
    np.testing.assert_allclose(ph.dist2bbox(torch.from_numpy(d), pa, xywh=xywh).numpy(),
                               np.asarray(jh.dist2bbox(jnp.asarray(d), ja, xywh=xywh)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("version,imgsz", [("v10", (96, 64)), ("v11", (64, 128)), ("v8", (64, 64))])
def test_full_model_matches_jax(version, imgsz):
    jm = JaxYOLOModel(version=version, scale="n", nc=2, task="segment")
    x = np.random.default_rng(3).uniform(0, 1, (2, *imgsz, 3)).astype(np.float32)
    variables = seeded_jax_variables(jm, jnp.asarray(x[:1]), seed=4)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    pm = port_model_from_jax(version, "n", 2, "segment", variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for k in ("boxes", "probs", "coeffs", "proto"):
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)


def test_bridge_matches_jax_export():
    """Same keys and arrays as the JAX package's exporter, and exactly the port
    model's parameters and statistics (Proto's ConvTranspose flipped)."""
    jm = JaxYOLOModel(version="v10", scale="n", nc=1, task="segment")
    variables = seeded_jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=6)
    ours, theirs = export_yolo_state_dict(variables), jax_export(variables)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    pm = port_model_from_jax("v10", "n", 1, "segment", variables)
    model_keys = {k for k in pm.state_dict() if not k.endswith("num_batches_tracked")}
    assert model_keys == set(ours)
    up = "model.23.proto.upsample.weight"
    np.testing.assert_array_equal(
        pm.state_dict()[up].numpy(),
        variables["params"]["model_23"]["proto"]["upsample"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1),
    )


def test_ultralytics_pt_loads_through_stub_reader(tmp_path):
    """An ultralytics-style .pt (module pickled under 'model') loads into the port's
    YOLO and gives the independent torch twin's forward."""
    from tests.torch_ref.yolo_torch import YOLOTorch, randomize
    from yolo_puncture_tpu_torch.predict.predictor import YOLO

    tm = randomize(YOLOTorch(version="v11", scale="n", nc=1, task="segment"), seed=0)
    path = os.path.join(tmp_path, "yolo11n-seg-finetune.pt")
    torch.save({"model": tm, "train_args": {"imgsz": 64}}, path)
    det = YOLO(path, nc=1, device="cpu")
    x = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = det.model(torch.from_numpy(x))
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"].numpy(), **TOL)
    np.testing.assert_allclose(got["probs"].numpy(), ref["probs"].numpy(), **TOL)
    np.testing.assert_allclose(got["coeffs"].numpy(), ref["coeffs"].numpy(), **TOL)
    np.testing.assert_allclose(got["proto"].numpy(), ref["proto"].permute(0, 2, 3, 1).numpy(), **TOL)


def test_seeded_init_is_deterministic_and_alive():
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel

    a = YOLOModel("v10", "n", 1, "segment").reset_parameters(torch.Generator().manual_seed(3))
    b = YOLOModel("v10", "n", 1, "segment").reset_parameters(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = a(x)
    assert torch.isfinite(out["probs"]).all() and out["probs"].std() > 0
    assert out["coeffs"].std() > 0
