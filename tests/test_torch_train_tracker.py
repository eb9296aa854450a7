"""Tracker training of the PyTorch port against the JAX package (``track/train.py``).

The same numpy inputs and seeded weights go through the JAX package's
propagation losses (``jax.value_and_grad``, jitted) and the port's, whose
rollout runs the kernels' plain versions on the CPU with the gradients of
``MemoryReadout`` and ``DecodeTail``.  Sizes: a 32×48 tracker, 2 objects, a
ring of 4 written every frame, long-term memory off, clips of 4 frames.

Limits: the loss within 1e-5 relative (measured 1e-7); each parameter's
gradient ‖g_port − g_jax‖ ≤ 1e-4 · ‖g_jax‖ + 1e-6 · ‖all of g_jax‖ (measured 2.6e-5
per tensor: fp32 sums in another order through ten recurrent network
applications).  The second term is for the key projection, whose gradient
nearly cancels between the query and the key paths (its norm is 1e-5 of the
whole), where the same absolute rounding is a larger share of a small number.
The clip makers are held bit for bit.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import seeded_tracker_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.track import train as pt
from yolo_puncture_tpu_torch.track.core import TrackerCore
from yolo_puncture_tpu_torch.utils.convert import export_tracker_state_dict

H, W, NO, T = 32, 48, 2, 4
CORE = dict(image_size=(H, W), max_objects=NO, mem_frames=4, mem_every=1, enable_long_term=False)
LOSS_REL = 1e-5
GRAD_REL, GRAD_GLOBAL = 1e-4, 1e-6


def _clip(seed, maker="make_domain_randomized_clip"):
    images, masks = getattr(pt, maker)(np.random.default_rng(seed), T, H, W, NO)
    return images, masks, (masks.sum((0, 2, 3)) > 0).astype(np.float32)


@pytest.mark.parametrize("maker", ["make_synthetic_clip", "make_domain_randomized_clip", "make_needle_serving_clip"])
def test_clip_makers_give_the_jax_packages_arrays(maker):
    from yolo_puncture_tpu.track import train as jt

    for seed in range(6):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):                           # and the generator's state after a clip
            got = getattr(pt, maker)(r1, 5, 48, 64, 3)
            ref = getattr(jt, maker)(r2, 5, 48, 64, 3)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and np.array_equal(g, r)


def _assert_grads_match(net, jax_param_grads):
    ref = export_tracker_state_dict({"params": jax_param_grads})
    total = np.sqrt(sum(float(np.sum(np.square(r))) for r in ref.values()))
    for name, p in net.named_parameters():
        r = ref[name]
        err = float(np.linalg.norm(p.grad.numpy() - r))
        assert err <= GRAD_REL * np.linalg.norm(r) + GRAD_GLOBAL * total, (name, err, np.linalg.norm(r), total)


def _jax_value_and_grad(loss_fn, variables, images, masks, valid):
    import jax
    import jax.numpy as jnp

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables, jnp.asarray(images), jnp.asarray(masks),
                                                       jnp.asarray(valid))
    return float(loss), jax.device_get(grads["params"])


@pytest.mark.parametrize("windowed", [False, True])
def test_propagation_loss_and_gradients_match_jax(windowed):
    """Per frame (``build_propagation_loss``) and through the windowed program
    (``build_windowed_propagation_loss``, one window of 3): the loss of a clip
    and every parameter's gradient, as ``PropagationTrainer`` takes them."""
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.track import train as jt
    from yolo_puncture_tpu.track.core import TrackerCore as JaxCore

    variables = seeded_tracker_variables(seed=1, image_hw=(H, W))
    images, masks, valid = _clip(3)
    jcore = JaxCore(variables=jax.tree.map(jnp.asarray, variables), **CORE)
    jloss = jt.build_windowed_propagation_loss(jcore, 3) if windowed else jt.build_propagation_loss(jcore)
    ref_loss, ref_grads = _jax_value_and_grad(jloss, jcore.variables, images, masks, valid)

    core = TrackerCore(variables=variables, device="cpu", **CORE)
    trainer = pt.PropagationTrainer(core, window_mix=1.0 if windowed else 0.0, window=3)
    batch = [torch.from_numpy(a)[None] for a in (images, masks, valid)]
    loss = trainer.loss_and_grads(*batch, windowed=windowed)
    assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss)
    _assert_grads_match(core.net, ref_grads)
    assert not core.memory.valid.any()                      # the rollout left the template memory as it was


def test_shared_backbone_loss_and_gradients_match_jax():
    """``pyramid_fn``: the frozen YOLOv10-n's pyramid at 4/3 of the tracker's
    geometry (64 × 64), the pyramid adapter and the decoder trained."""
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import seeded_jax_variables
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLO
    from yolo_puncture_tpu.track import train as jt
    from yolo_puncture_tpu.track.core import TrackerCore as JaxCore
    from yolo_puncture_tpu.track.network import PropagationNetwork as JaxNet

    from yolo_puncture_tpu_torch.models.yolo import pyramid_channels_for

    channels = pyramid_channels_for("v10", "n")
    assert channels == jt.pyramid_channels_for("v10", "n")
    # the adapter's projections take the n-scale pyramid's widths
    variables = seeded_jax_variables(JaxNet(with_pyramid_adapter=True, pyramid_channels=channels),
                                     jnp.zeros((1, H, W, 3)), seed=2)
    bvars = seeded_jax_variables(JaxYOLO(version="v10", scale="n", nc=1, task="segment"),
                                 jnp.zeros((1, 64, 64, 3)), seed=4)
    images, masks, valid = _clip(5)
    kw = dict(CORE, pyramid_adapter=True, pyramid_channels=channels)
    jcore = JaxCore(variables=jax.tree.map(jnp.asarray, variables), **kw)
    jfn, _ = jt.make_yolo_pyramid_fn(scale="n", variables=jax.tree.map(jnp.asarray, bvars))
    ref_loss, ref_grads = _jax_value_and_grad(jt.build_propagation_loss(jcore, jfn), jcore.variables,
                                              images, masks, valid)

    core = TrackerCore(variables=variables, device="cpu", **kw)
    pfn, _ = pt.make_yolo_pyramid_fn(scale="n", variables=bvars, device="cpu")
    trainer = pt.PropagationTrainer(core, pyramid_fn=pfn)
    loss = trainer.loss_and_grads(*(torch.from_numpy(a)[None] for a in (images, masks, valid)))
    assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss)
    _assert_grads_match(core.net, ref_grads)


def test_trainer_checks_its_options():
    core = TrackerCore(device="cpu", **CORE)
    with pytest.raises(ValueError, match="multiple of window"):
        pt.PropagationTrainer(core, clip_len=4, window_mix=0.5, window=2)
    with pytest.raises(ValueError, match="self-contained"):
        pt.PropagationTrainer(core, window_mix=0.5, pyramid_fn=lambda x: x)
    trainer = pt.PropagationTrainer(core, clip_len=4, batch_size=2, window_mix=0.5, window=3, seed=4)
    images, onehot, valid = trainer._sample_batch()
    assert tuple(images.shape) == (2, 4, H, W, 3) and tuple(onehot.shape) == (2, 4, NO, H, W)
    assert tuple(valid.shape) == (2, NO)
    assert np.isfinite(trainer.fit(steps=2, log_every=0))
    assert 0.0 <= trainer.eval_propagation_iou(2) <= 1.0
