"""bf16 training of the fine-tuners and bf16 U²-Net: the rule of ``tests/test_torch_bf16_train.py``.

One ``ClassifierFinetuner`` step on bf16 B0 and VAN-B0, one ``UNetFinetuner`` step
on bf16 U2NETP, each against the JAX package's fine-tuner on the bf16 model, and
``UNetPredictor(dtype=bfloat16)`` against the JAX package's.  Apart from the
tracker's file so that the suite's workers share the JAX compiles.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from tests.test_torch_bf16_train import (  # noqa: F401  (torch_single_thread: autouse fixture)
    BF16,
    GRAD_FLOOR,
    RULE,
    RAN,
    _d,
    _hold,
    _hold_tree,
    assert_adam_on_fp32_masters,
    assert_fp32_training_state,
    torch_single_thread,
)


# ---------------------------------------------------------------------------
# the fine-tuners and U²-Net
# ---------------------------------------------------------------------------

S = 64
NO_DROPOUT = {"b0": (1.0, 1.0, 224, 0.0)}


def _capture_grads():
    """An optax transformation that moves nothing and keeps the gradient as its
    state: the JAX fine-tuners' own jitted step then returns the exact fp32
    gradient in ``opt_state``."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def _jax_finetune_step(ft, params, stats, *batch):
    """(loss, gradient tree) of the JAX fine-tuner ``ft``'s own jitted step."""
    ft.tx = _capture_grads()                       # read when the step is traced
    out = ft._step(params, stats, ft.tx.init(params), *batch)
    return float(out[3]), jax.device_get(out[2])


def _port_finetune_step(ft, step_args):
    before = {k: p.detach().numpy().copy() for k, p in ft.weights.named.items()}
    loss = ft.step(*step_args)
    loss = loss[0] if isinstance(loss, tuple) else loss
    return float(loss), {k: p.grad.numpy() for k, p in ft.weights.named.items()}, ft, before


@pytest.mark.parametrize("family", ["efficientnet_b0", "van_b0"])
def test_classifier_finetuner_bf16_step_matches_jax(family):
    """One ``ClassifierFinetuner`` step on a bf16 B0 or VAN-B0 at 64², batch 4,
    against the JAX package's fine-tuner on ``dtype=bfloat16`` (dropout off on
    both sides): the loss by RULE, the gradients by ``_hold_tree`` with
    GRAD_FLOOR, RAN; Adam on fp32 masters that start at the fp32 weights;
    masters and Adam's moments fp32."""
    import types
    from unittest import mock

    from tests.torch_parity import classifier_images, seeded_classifier_variables
    from yolo_puncture_tpu.models import efficientnet as jeff
    from yolo_puncture_tpu.models import van as jvan
    from yolo_puncture_tpu.train import finetune as jft
    from yolo_puncture_tpu_torch.models import efficientnet as peff
    from yolo_puncture_tpu_torch.tasks import ClassifierNet
    from yolo_puncture_tpu_torch.train import finetune as pft
    from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict

    van = family.startswith("van")
    variables = seeded_classifier_variables("b0", S, family="van" if van else "efficientnet")
    crops, labels = classifier_images(S, n=4), np.array([0, 1, 1, 0], np.int32)
    lr = 1e-3

    def jax_run(dt):
        model = jvan.VAN(variant="b0", num_classes=2, dtype=dt) if van else jeff.EfficientNet(
            variant="b0", num_classes=2, dtype=dt)
        v = jax.tree.map(jnp.asarray, variables)
        with mock.patch.dict(jeff._CFG, NO_DROPOUT):
            ft = jft.ClassifierFinetuner(types.SimpleNamespace(model=model, variables=v, input_size=S), lr=lr)
            loss, g = _jax_finetune_step(ft, v["params"], v["batch_stats"], jnp.asarray(crops),
                                         jnp.asarray(labels), jnp.asarray(0, jnp.int32))
        return loss, export_classifier_state_dict({"params": g})

    def port_run(dtype):
        with mock.patch.dict(peff._CFG, NO_DROPOUT):
            net = ClassifierNet(family, input_size=S, variables=variables, device="cpu", dtype=dtype)
        return _port_finetune_step(pft.ClassifierFinetuner(net, lr=lr),
                                   (torch.from_numpy(crops), torch.from_numpy(labels)))

    j32, j16, p16, p32 = jax_run(jnp.float32), jax_run(jnp.bfloat16), port_run(BF16), port_run(torch.float32)
    print(f"{family} loss: JAX fp32 {j32[0]:.7f}, JAX bf16 {j16[0]:.7f}, port bf16 {p16[0]:.7f}")
    assert abs(p16[0] - j32[0]) <= RULE * abs(j16[0] - j32[0]) + 1e-6 * abs(j32[0])
    _hold_tree(f"{family} gradients", p16[1], j16[1], j32[1], p32[1], GRAD_FLOOR)
    ft = p16[2]
    assert_adam_on_fp32_masters(ft.weights.named, p16[3], export_classifier_state_dict(variables), lr)
    assert_fp32_training_state(ft.net.model, ft.weights.named, ft.opt)


def _unet_variables():
    from tests.torch_parity import seeded_u2net_variables, unet_images

    return seeded_u2net_variables(True, unet_images(S, S))


def _port_unet(variables, dtype):
    from yolo_puncture_tpu_torch.tasks import UNetPredictor
    from yolo_puncture_tpu_torch.utils.convert import export_u2net_state_dict

    pred = UNetPredictor("u2netp", device="cpu", dtype=dtype)
    pred.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                                export_u2net_state_dict(variables).items()}, strict=False)
    return pred


def test_unet_finetuner_bf16_step_matches_jax():
    """One ``UNetFinetuner`` step on a bf16 U2NETP at 64², batch 2, against the
    JAX package's on ``U2Net(dtype=bfloat16)``: the loss by RULE, the gradients by
    ``_hold_tree`` with GRAD_FLOOR, RAN; Adam on fp32 masters that start at the
    fp32 weights; masters and Adam's moments fp32; ``recalibrate_batch_stats`` on
    the bf16 model leaves fp32 statistics."""
    import types

    from tests.torch_parity import unet_images
    from yolo_puncture_tpu.models.u2net import U2Net as JaxU2Net
    from yolo_puncture_tpu.train import finetune as jft
    from yolo_puncture_tpu_torch.train import finetune as pft
    from yolo_puncture_tpu_torch.utils.convert import export_u2net_state_dict

    variables = _unet_variables()
    bgr = unet_images(S, S, n=2)
    images = (bgr[..., ::-1].astype(np.float32) / 255.0)
    masks = (bgr.max(-1) > 200).astype(np.float32)
    lr = 1e-3

    def jax_run(dt):
        v = jax.tree.map(jnp.asarray, variables)
        ft = jft.UNetFinetuner(types.SimpleNamespace(model=JaxU2Net(small=True, dtype=dt), variables=v), lr=lr)
        loss, g = _jax_finetune_step(ft, v["params"], v["batch_stats"], jnp.asarray(images), jnp.asarray(masks))
        return loss, export_u2net_state_dict({"params": g})

    def port_run(dtype):
        return _port_finetune_step(pft.UNetFinetuner(_port_unet(variables, dtype), lr=lr),
                                   (torch.from_numpy(images), torch.from_numpy(masks)))

    j32, j16, p16, p32 = jax_run(jnp.float32), jax_run(jnp.bfloat16), port_run(BF16), port_run(torch.float32)
    print(f"u2netp loss: JAX fp32 {j32[0]:.7f}, JAX bf16 {j16[0]:.7f}, port bf16 {p16[0]:.7f}")
    assert abs(p16[0] - j32[0]) <= RULE * abs(j16[0] - j32[0]) + 1e-6 * abs(j32[0])
    _hold_tree("u2netp gradients", p16[1], j16[1], j32[1], p32[1], GRAD_FLOOR)
    ft = p16[2]
    assert_adam_on_fp32_masters(ft.weights.named, p16[3], export_u2net_state_dict({"params": variables["params"]}),
                                lr)
    assert_fp32_training_state(ft.predictor.model, ft.weights.named, ft.opt)
    stats = pft.recalibrate_batch_stats(ft.predictor.model, [torch.from_numpy(images).permute(0, 3, 1, 2)])
    assert stats and all(v.dtype == torch.float32 for v in stats.values())


def test_unet_predictor_bf16_matches_jax():
    """``UNetPredictor(dtype=bfloat16)`` against the JAX package's on the same
    weights and the frames their statistics were measured on: the seven side
    outputs of the forward by RULE each (and RAN from the port's fp32 forward
    over the seven); ``predict``'s mask is its bf16 fused map, min-max normalised
    in fp32, above 0.5.  (The masks of this seeded U2NETP are not compared with
    JAX's: its fused map spans a narrow range, so one rounding flips a sixth to a
    quarter of the pixels after the normalisation, in either package.)"""
    from tests.torch_parity import unet_images
    from yolo_puncture_tpu.models.u2net import U2Net as JaxU2Net
    from yolo_puncture_tpu_torch.models.u2net import norm_pred

    variables = _unet_variables()
    bgr = unet_images(S, S)
    x = bgr[..., ::-1].astype(np.float32) / 255.0

    def jax_outs(dt):
        v = jax.tree.map(jnp.asarray, variables)
        return jax.jit(lambda v, x: JaxU2Net(small=True, dtype=dt).apply(v, x))(v, jnp.asarray(x))

    p16, p32 = _port_unet(variables, BF16), _port_unet(variables, torch.float32)
    assert next(p16.model.parameters()).dtype == BF16
    with torch.no_grad():
        o16 = [o.permute(0, 2, 3, 1) for o in p16.model(torch.from_numpy(x).permute(0, 3, 1, 2))]
        o32 = [o.permute(0, 2, 3, 1) for o in p32.model(torch.from_numpy(x).permute(0, 3, 1, 2))]
    assert all(o.dtype == BF16 for o in o16)
    j32, j16 = jax_outs(jnp.float32), jax_outs(jnp.bfloat16)
    for i, (a, b, c) in enumerate(zip(o16, j16, j32)):
        _hold(f"u2netp side output {i}", a, b, c)
    gap = sum(_d(b, c) for b, c in zip(j16, j32))
    ran = sum(_d(a, e) for a, e in zip(o16, o32))
    print(f"u2netp side outputs: JAX bf16 vs fp32 {gap:.4g}, port bf16 vs port fp32 {ran / gap:.3f}x")
    assert ran >= RAN * gap
    for i, frame in enumerate(bgr):
        got = p16.predict(frame)
        want = ((norm_pred(o16[0][i, ..., 0].float()) > 0.5).to(torch.uint8) * 255).numpy()
        assert got.dtype == np.uint8 and got.shape == frame.shape[:2] and np.array_equal(got, want)
