"""The port's bf16 serving configuration against the JAX package's bf16 one.

Weights: ``seeded_detector_variables`` (YOLOv8n-seg and YOLOv10n-seg at imgsz 64,
BatchNorm statistics of the clip) and ``seeded_classifier_variables`` (B0 at 96²);
frames: the 96×128 BGR needle clip of ``chip_smoke.needle_clip``.

A seeded network whose BatchNorm statistics are measured on its inputs keeps
every layer near unit scale, so a rounding anywhere travels to the outputs: the
JAX package's own bf16 forward differs from its fp32 forward by about 5 px in
the boxes at imgsz 64.  Two rules hold the port where equality cannot:

  * ``RULE``: the port's bf16 output is no farther from the JAX fp32 output than
    1.5 times the JAX bf16 output is (mean absolute error over the outputs), so
    that a wrong rounding order cannot hide inside a tolerance;
  * ``DIRECT``: the port's bf16 output is within twice the JAX bf16 error of the
    JAX bf16 output (two independent roundings of one network differ by about
    √2 times one rounding's error).

Where the inputs of a step are the same on both sides, the step is held
exactly: the letterbox and the resamplers bit for bit, the selection (ties
included) index for index, the mask decode within one bf16 ulp, and ``predict``
and the pipeline's device step with the networks' outputs handed over from the
JAX side (``_HandOver``), which checks that the port feeds them the same bf16
input.  Layer by layer, with JAX's bf16 input fed to both, each layer of the
YOLO graph is within ``LAYER_TOL`` of JAX's bf16 output (XLA's CPU backend
computes bf16 transcendentals with its own approximations, the port in fp32
rounded once).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import needle_clip
from tests.torch_parity import (  # noqa: F401
    classifier_images,
    seeded_classifier_variables,
    seeded_detector_variables,
    torch_single_thread,
)
from yolo_puncture_tpu.models.efficientnet import preprocess_classifier as jax_preprocess
from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
from yolo_puncture_tpu.ops.letterbox import letterbox as jax_letterbox
from yolo_puncture_tpu.ops.masks import decode_masks as jax_decode_masks
from yolo_puncture_tpu.ops.nms import select_detections as jax_select_detections
from yolo_puncture_tpu.ops.pallas.proto_decode import proto_decode_pallas
from yolo_puncture_tpu.pipeline import runner as jrun
from yolo_puncture_tpu.predict.predictor import YOLO as JaxYOLO
from yolo_puncture_tpu.tasks.classify import ClassifierNet as JaxClassifierNet
from yolo_puncture_tpu_torch.models.yolo import YOLOModel
from yolo_puncture_tpu_torch.nn.common import upsample_nearest_2x
from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode_reference
from yolo_puncture_tpu_torch.ops.letterbox import letterbox
from yolo_puncture_tpu_torch.ops.masks import decode_masks
from yolo_puncture_tpu_torch.ops.nms import select_detections
from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
from yolo_puncture_tpu_torch.predict.predictor import YOLO
from yolo_puncture_tpu_torch.tasks import ClassifierNet
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

BF16 = torch.bfloat16
H, W, IMGSZ, CROP = 96, 128, 64, 96
NAMES = {"v8": "yolov8n-seg", "v10": "yolov10n-seg"}
RULE = 1.5
DIRECT = 2.0
LAYER_TOL = 2.0 ** -4   # a layer's max abs difference, relative to its largest output
# Past the networks, where both sides are fed the same values: XLA fuses the JAX
# package's jitted bf16 chain (decode → paste → threshold; preprocessing →
# classifier → softmax) and keeps fp32 between fused operations, where the port
# rounds each operation's output to bf16.  So a few boundary pixels of a mask
# flip, and a probability moves by a few bf16 ulps of the logits.
MASK_AGREE = 0.995
PROB_ATOL = 1e-3


def _frames(n=8):
    return needle_clip(n, H, W, key_frame=3, seed=3)[0]


@functools.lru_cache(maxsize=None)
def _variables(version):
    return seeded_detector_variables(version, _frames(), IMGSZ)


def _t(a, dtype=None):
    """jax / numpy array → torch (bf16 stays bf16)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mean_err(a, b):
    return float(np.abs(_f32(a) - _f32(b)).mean())


def _bf16_ulp(x):
    a = np.abs(_f32(x))
    return np.where(a > 0, np.exp2(np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 0.0)


def _assert_rules(name, port16, jax16, jax32):
    e_jax, e_port, e_direct = _mean_err(jax16, jax32), _mean_err(port16, jax32), _mean_err(port16, jax16)
    print(f"{name}: JAX bf16 vs fp32 {e_jax:.4g}, port bf16 vs JAX fp32 {e_port:.4g} "
          f"({e_port / e_jax:.3f}x), port bf16 vs JAX bf16 {e_direct:.4g} ({e_direct / e_jax:.3f}x)")
    assert e_port <= RULE * e_jax, name
    assert e_direct <= DIRECT * e_jax, name


# ---------------------------------------------------------------------------
# letterbox and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 128, 64), (64, 64, 64), (192, 192, 64)],
                         ids=["exact-2x", "same-size", "exact-3x"])
def test_letterbox_bf16_matches_jax_bit_for_bit(shape):
    """The exact integer shrinks where the JAX package applies the H taps first
    in bf16 and the W taps in one fp32 contraction, and the same-size path.
    (Where its output row is a multiple of 384 lanes, as at 640², and at a
    general ratio, the JAX bf16 letterbox contracts bf16 × bf16 into fp32,
    which XLA's CPU backend cannot run: ``test_letterbox_bf16_at_640_rounds_the_exact_sum``.)"""
    h, w, size = shape
    rng = np.random.default_rng(h + w)
    frames = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    ref, r, pad = jax_letterbox(jnp.asarray(frames), size, dtype=jnp.bfloat16, bgr_to_rgb=True)
    got, r2, pad2 = letterbox(torch.from_numpy(frames), size, bgr_to_rgb=True, dtype=BF16)
    assert got.dtype == BF16 and (r2, pad2) == (r, pad)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    ref32, _, _ = jax_letterbox(jnp.asarray(frames), size, dtype=jnp.float32, bgr_to_rgb=True)
    assert _mean_err(got, ref32) <= RULE * _mean_err(ref, ref32)


def test_letterbox_bf16_at_640_rounds_the_exact_sum():
    """720p → 640² (W taps first, 640·3 lanes a multiple of 384): every product of
    a pixel and a bf16 tap weight and their sums are exact in fp32, so the bf16
    letterbox is the exact (float64) sum rounded once to bf16."""
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (1, 720, 1280, 3), dtype=np.uint8)
    got, r, (left, top) = letterbox(torch.from_numpy(frames), 640, bgr_to_rgb=True, dtype=BF16)
    m = float(torch.tensor(0.5 / 255, dtype=torch.float32).to(BF16))
    x = frames.astype(np.float64).reshape(1, 360, 2, 640, 2, 3)
    exact = 0.5 * (m * x[:, :, 0, :, 0] + m * x[:, :, 0, :, 1]) + 0.5 * (m * x[:, :, 1, :, 0] + m * x[:, :, 1, :, 1])
    ref = torch.from_numpy(exact[..., ::-1].copy()).to(BF16)
    assert (r, left, top) == (0.5, 0, 140)
    assert torch.equal(got[:, top:top + 360], ref)
    assert float(got[0, 0, 0, 0]) == float(torch.tensor(114 / 255).to(BF16))


@functools.lru_cache(maxsize=None)
def _forwards(version):
    """(JAX fp32 outputs, JAX bf16 outputs, JAX bf16 intermediates, port bf16 model)."""
    variables = _variables(version)
    frames = jnp.asarray(_frames())
    imgs32, _, _ = jax_letterbox(frames, IMGSZ, dtype=jnp.float32, bgr_to_rgb=True)
    imgs16, _, _ = jax_letterbox(frames, IMGSZ, dtype=jnp.bfloat16, bgr_to_rgb=True)
    j32 = jax.jit(JaxYOLOModel(version=version, scale="n", nc=1, task="segment").apply)(variables, imgs32)
    j16, state = jax.jit(functools.partial(
        JaxYOLOModel(version=version, scale="n", nc=1, task="segment", dtype=jnp.bfloat16).apply,
        capture_intermediates=True, mutable=["intermediates"]))(variables, imgs16)
    model = YOLOModel(version, "n", 1, "segment", dtype=BF16)
    load_yolo_state_dict(model, export_yolo_state_dict(variables))
    return j32, j16, state["intermediates"], model.eval(), imgs16


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_yolo_forward_bf16_matches_jax(version):
    j32, j16, _, model, imgs16 = _forwards(version)
    with torch.no_grad():
        got = model(_t(imgs16))
    assert got["boxes"].dtype == got["probs"].dtype == torch.float32   # fp32 anchors and sigmoid, as JAX
    assert got["coeffs"].dtype == got["proto"].dtype == BF16
    for k in ("boxes", "probs", "coeffs", "proto"):
        assert tuple(got[k].shape) == tuple(j16[k].shape)
        _assert_rules(f"{version} {k}", got[k], j16[k], j32[k])


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_yolo_layers_bf16_match_jax_layer_by_layer(version):
    """Each layer of the graph fed JAX's bf16 input of that layer, against JAX's
    bf16 output: within LAYER_TOL of the layer's largest value."""
    _, j16, inter, model, imgs16 = _forwards(version)

    def nchw(a):
        return _t(a).permute(0, 3, 1, 2)

    saved, x = {}, nchw(imgs16)
    for i, (frm, _, block, _) in enumerate(model.spec):
        ins = [x if j == -1 else saved[j] for j in (frm if isinstance(frm, tuple) else (frm,))]
        with torch.no_grad():
            if block == "Concat":
                y = torch.cat(ins, 1)
            elif block == "Upsample":
                y = upsample_nearest_2x(ins[0])
            elif block == "HEAD":
                out = model.model[i](ins)
                for k in ("boxes", "probs", "coeffs", "proto"):
                    ref = _f32(j16[k])
                    d = float(np.abs(_f32(out[k]) - ref).max())
                    print(f"{version} head {k}: max abs diff {d:.4g} of max {np.abs(ref).max():.4g}")
                    assert d <= LAYER_TOL * float(np.abs(ref).max()), k
                continue
            else:
                y = model.model[i](ins[0])
                ref = inter[f"model_{i}"]["__call__"][0]
                d = float((y.float() - nchw(ref).float()).abs().max())
                scale = float(np.abs(_f32(ref)).max())
                print(f"{version} layer {i} {block}: max abs diff {d:.4g} of max {scale:.4g}")
                assert y.dtype == BF16 and d <= LAYER_TOL * scale, (i, block)
                y = nchw(ref)
        saved[i] = x = y


def test_bf16_models_hold_the_fp32_weights_rounded():
    """A seeded bf16 detector and classifier are the fp32 ones with their weights
    rounded to bf16 and their BatchNorm statistics kept in fp32."""
    for make in (lambda dt: YOLO("yolo10n-seg", nc=1, seed=3, dtype=dt, device="cpu").model,
                 lambda dt: ClassifierNet("efficientnet_b0", input_size=64, seed=3, dtype=dt, device="cpu").model):
        m32, m16 = make(torch.float32), make(BF16)
        sd32, sd16 = m32.state_dict(), m16.state_dict()
        for k, v in sd32.items():
            if "bn" in k or k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                assert sd16[k].dtype == v.dtype and torch.equal(sd16[k], v), k
            elif v.is_floating_point() and ".bn." not in k:
                is_bn = sd16[k].dtype == torch.float32
                assert torch.equal(sd16[k], v if is_bn else v.to(BF16)), k


# ---------------------------------------------------------------------------
# selection, decode, the plain kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version,max_det", [("v10", 8), ("v10", 300), ("v8", 20)])
def test_select_detections_on_bf16_scores_keeps_jax_tie_order(version, max_det):
    """Scores from bf16 class logits tie often; both sides rank ties by the
    lower index (the JAX package's unrolled argmax for max_det ≤ 32, lax.top_k
    above, and its NMS): the same anchors in the same order."""
    _, j16, _, _, _ = _forwards(version)
    ref = jax_select_detections(j16, nms_free=version == "v10", conf_thres=0.0, max_det=max_det)
    got = select_detections({k: _t(j16[k]) for k in ("boxes", "probs", "coeffs")},
                            nms_free=version == "v10", conf_thres=0.0, max_det=max_det)
    scores = np.asarray(j16["probs"])[..., 0]
    n_tied = sum(len(s) - len(np.unique(s)) for s in scores)
    print(f"{version} max_det {max_det}: {n_tied} tied scores")
    assert n_tied > 20       # anchors share a score in bf16
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(ref["indices"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(ref["scores"]))
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(ref["boxes"]))
    assert got["coeffs"].dtype == BF16
    np.testing.assert_array_equal(_f32(got["coeffs"]), _f32(ref["coeffs"]))


@pytest.mark.parametrize("upsample,threshold,crop",
                         [(False, None, True), (False, 0.5, True), (False, None, False),
                          (True, None, True), (True, 0.5, True), (True, 0.5, False)])
def test_decode_masks_bf16_matches_jax(upsample, threshold, crop):
    """The selected instances' masks from the JAX bf16 head: the sigmoid rounded
    to bf16, then upsample, crop and threshold in bf16 on both sides.  Soft
    masks within one bf16 ulp (an fp32 sum in another order may round the other
    way), binary masks equal except where the soft value is within one ulp of
    the threshold."""
    _, j16, _, _, _ = _forwards("v10")
    det = jax_select_detections(j16, nms_free=True, conf_thres=0.0, max_det=8)
    args = (j16["proto"], det["coeffs"], det["boxes"])
    run = jax.jit(lambda p, c, b: jax_decode_masks(p, c, b, (IMGSZ, IMGSZ), upsample=upsample,
                                                       threshold=threshold, crop=crop))
    ref = run(*args)
    got = decode_masks(*(_t(a) for a in args), (IMGSZ, IMGSZ), upsample=upsample, threshold=threshold, crop=crop)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16 and tuple(got.shape) == tuple(ref.shape)
    diff = np.abs(_f32(got) - _f32(ref))
    print(f"decode upsample={upsample} thr={threshold} crop={crop}: {int((diff > 0).sum())} of {diff.size} differ")
    if threshold is None:
        assert (diff <= _bf16_ulp(np.maximum(np.abs(_f32(got)), np.abs(_f32(ref))))).all()
    else:
        soft = _f32(jax.jit(lambda p, c, b: jax_decode_masks(p, c, b, (IMGSZ, IMGSZ), upsample=upsample,
                                                                threshold=None, crop=crop))(*args))
        assert not ((diff > 0) & (np.abs(soft - threshold) > _bf16_ulp(np.float32(threshold)))).any()


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_proto_decode_plain_bf16_matches_pallas_interpret(threshold):
    """The plain version of the kernel on bf16 protos and coefficients against
    ``proto_decode_pallas(interpret=True)`` fed the same bf16 arrays (it widens
    them and returns fp32): soft masks are its values rounded to bf16 (half an
    ulp, and 1e-6 for the fp32 sums), binary masks equal except within one ulp
    of the threshold, where the port thresholds the rounded value as the JAX
    package's ``decode_masks`` does."""
    rng = np.random.default_rng(5)
    B, N, Hp, Wp = 2, 6, 16, 24
    protos = jnp.asarray(rng.standard_normal((B, Hp, Wp, 32)), jnp.bfloat16)
    coeffs = jnp.asarray(0.5 * rng.standard_normal((B, N, 32)), jnp.bfloat16)
    x1, y1 = rng.uniform(-2, Wp * 0.6, (B, N)), rng.uniform(-2, Hp * 0.6, (B, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, Wp, (B, N)), y1 + rng.uniform(1, Hp, (B, N))], -1)
    boxes[:, ::2] = np.round(boxes[:, ::2])
    boxes = jnp.asarray(boxes, jnp.float32)
    ref = np.stack([np.asarray(proto_decode_pallas(protos[b], coeffs[b], boxes[b], threshold=threshold,
                                                   interpret=True)) for b in range(B)])
    got = proto_decode_reference(_t(protos).permute(0, 3, 1, 2), _t(coeffs), _t(boxes), threshold)
    assert got.dtype == BF16
    if threshold is None:
        np.testing.assert_array_less(np.abs(_f32(got) - ref), 0.5 * _bf16_ulp(ref) + 1e-6 + 1e-12)
    else:
        soft = np.stack([np.asarray(proto_decode_pallas(protos[b], coeffs[b], boxes[b], threshold=None,
                                                        interpret=True)) for b in range(B)])
        assert not ((_f32(got) != ref) & (np.abs(soft - threshold) > _bf16_ulp(np.float32(threshold)))).any()


# ---------------------------------------------------------------------------
# predict, the classifier and the pipeline's device step
# ---------------------------------------------------------------------------


class _HandOver:
    """Stands in for the port's network: checks that it is fed ``expect`` (the
    JAX side's bf16 input) and returns the JAX side's outputs for it."""

    def __init__(self, expect, outputs, dtype=BF16, nchw=False):
        self.expect, self.outputs, self.dtype, self.nchw = expect, outputs, dtype, nchw
        self.calls = 0

    def __call__(self, x):
        assert x.dtype == BF16
        got = x.permute(0, 2, 3, 1) if self.nchw else x
        np.testing.assert_array_equal(_f32(got), _f32(self.expect[self.calls]))
        out = self.outputs[self.calls]
        self.calls += 1
        return {k: _t(v) for k, v in out.items()} if isinstance(out, dict) else _t(out)


def _predict_pair(max_masks, monkeypatch):
    variables = _variables("v10")
    monkeypatch.setattr(JaxYOLO, "_random_init", lambda self, seed: variables)
    jdet = JaxYOLO(NAMES["v10"], nc=1, max_det=20, max_masks=max_masks, dtype=jnp.bfloat16)
    pdet = YOLO(NAMES["v10"], nc=1, max_det=20, max_masks=max_masks, dtype=BF16, device="cpu")
    assert pdet.model.dtype == BF16
    frames = _frames(4)
    imgs, out = _jax_head(jdet.model, variables, frames)
    pdet.model = _HandOver([imgs], [out])
    return jdet, pdet, frames


def _jax_head(model, variables, frames):
    """The JAX bf16 letterbox and head outputs in one jitted program, as the JAX
    predictor and pipeline compute them (XLA rounds bf16 differently inside a
    fused program than op by op)."""
    @jax.jit
    def run(v, f):
        imgs, _, _ = jax_letterbox(f, IMGSZ, dtype=jnp.bfloat16, bgr_to_rgb=True)
        out = model.apply(v, imgs)
        return imgs, {k: out[k] for k in ("boxes", "probs", "coeffs", "proto")}

    return run(variables, jnp.asarray(frames))


@pytest.mark.parametrize("retina", [False, True])
@pytest.mark.parametrize("max_masks", [32, 3])
def test_predict_bf16_matches_jax(retina, max_masks, monkeypatch):
    """``YOLO(dtype=bf16).predict`` with the head's outputs handed over from the
    JAX bf16 model: selection, bf16 decode, paste, retina crop and threshold,
    and (max_masks 3) the overflow program: boxes within 1e-3 px, scores within
    1e-6, the same classes, masks at least MASK_AGREE equal."""
    jdet, pdet, frames = _predict_pair(max_masks, monkeypatch)
    conf = 0.0 if max_masks == 3 else 0.02
    ref = jdet.predict(list(frames), conf=conf, imgsz=IMGSZ, retina_masks=retina)
    got = pdet.predict(list(frames), conf=conf, imgsz=IMGSZ, retina_masks=retina)
    assert pdet.model.calls == 1
    n = 0
    for g, r in zip(got, ref):
        assert len(g.boxes) == len(r.boxes)
        n += len(r.boxes)
        np.testing.assert_array_equal(g.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.boxes.conf, r.boxes.conf, rtol=0, atol=1e-6)
        assert g.masks.data.shape == r.masks.data.shape
        for gm, rm in zip(g.masks.data, r.masks.data):
            agree = (gm == rm).mean()
            assert agree >= MASK_AGREE, agree
    assert n > 4 * max_masks if max_masks == 3 else n > 0


@functools.lru_cache(maxsize=None)
def _classifiers():
    variables = seeded_classifier_variables("b0", CROP, seed=7)
    jnets = {dt: JaxClassifierNet("efficientnet_b0", input_size=CROP, dtype=dt) for dt in (jnp.float32, jnp.bfloat16)}
    for j in jnets.values():
        j.variables = variables
    pnet = ClassifierNet("efficientnet_b0", input_size=CROP, variables=variables, dtype=BF16, device="cpu")
    return variables, jnets, pnet


def test_classifier_b0_bf16_logits_match_jax():
    """B0 logits on 32 seeded crops: bf16 input (the fp32 preprocessing cast at
    the end) equal, logits held by RULE and DIRECT."""
    variables, jnets, pnet = _classifiers()
    images = classifier_images(CROP, n=32)
    x16 = jax_preprocess(jnp.asarray(images), CROP, jnp.bfloat16)
    from yolo_puncture_tpu_torch.models.efficientnet import preprocess_classifier

    px = preprocess_classifier(torch.from_numpy(images), CROP, BF16)
    np.testing.assert_array_equal(_f32(px.permute(0, 2, 3, 1)), _f32(x16))
    j16 = jax.jit(jnets[jnp.bfloat16].model.apply)(variables, x16)
    j32 = jax.jit(jnets[jnp.float32].model.apply)(variables, jax_preprocess(jnp.asarray(images), CROP, jnp.float32))
    with torch.no_grad():
        got = pnet.model(px)
    assert got.dtype == BF16
    _assert_rules("B0 logits", got, j16, j32)
    idx, p, probs = pnet._forward(torch.from_numpy(images))
    assert probs.dtype == torch.float32                                   # the softmax stays fp32


def test_pipeline_step_bf16_matches_jax(monkeypatch):
    """One batch of the device step with a bf16 YOLOv10n and a bf16 B0, each
    network's outputs handed over from the JAX side for the bf16 input the port
    gives it (checked equal): valid, boxes, scores and classes exactly, masks
    at letterbox resolution at least MASK_AGREE equal, probabilities within
    PROB_ATOL."""
    variables = _variables("v10")
    cvars, jnets, _ = _classifiers()
    monkeypatch.setattr(JaxYOLO, "_random_init", lambda self, seed: variables)
    jdet = JaxYOLO(NAMES["v10"], nc=1, max_det=8, dtype=jnp.bfloat16)
    jpipe = jrun.VideoSpeedPipeline(jdet, jnets[jnp.bfloat16], device_batch=4, imgsz=IMGSZ, crop_size=CROP)
    pdet = YOLO(NAMES["v10"], nc=1, max_det=8, dtype=BF16, device="cpu")
    pcls = ClassifierNet("efficientnet_b0", input_size=CROP, variables=cvars, dtype=BF16, device="cpu")
    ppipe = VideoSpeedPipeline(pdet, pcls, device_batch=4, imgsz=IMGSZ, crop_size=CROP)
    frames = _frames(4)
    conf = 0.02
    ref = {k: np.asarray(v) for k, v in jpipe._step_fn(frames.shape[1:3])(
        variables, cvars, jnp.asarray(frames), jnp.float32(conf)).items()}

    imgs, head = _jax_head(jdet.model, variables, frames)
    pdet.model = _HandOver([imgs], [head])
    # the crops follow the boxes, which match: the JAX classifier on the port's crops
    crops = ppipe._crops(torch.from_numpy(frames), torch.from_numpy(ref["box"]))
    x16 = jax_preprocess(jnp.asarray(crops.numpy()), CROP, jnp.bfloat16)
    pcls.model = _HandOver([x16], [jax.jit(jnets[jnp.bfloat16].model.apply)(cvars, x16)], nchw=True)
    got, r, pad = ppipe._step(torch.from_numpy(frames), conf)
    assert pdet.model.calls == pcls.model.calls == 1
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["box"].numpy(), ref["box"])
    np.testing.assert_array_equal(got["conf"].numpy(), ref["conf"])
    np.testing.assert_array_equal(got["cls"].numpy(), ref["cls"])
    np.testing.assert_allclose(got["cls_prob"].numpy(), ref["cls_prob"], rtol=0, atol=PROB_ATOL)
    assert got["mask_lb"].dtype == torch.uint8
    for g, m in zip(got["mask_lb"].numpy(), ref["mask_lb"]):
        print(f"pipeline mask agreement {(g == m).mean():.5f}")
        assert (g == m).mean() >= MASK_AGREE
    assert 0 < int(ref["valid"].sum())
