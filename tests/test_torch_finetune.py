"""The fine-tuners of the PyTorch port (``train/finetune.py``) against the JAX package's.

The same seeded numpy weights (``tests/torch_parity.py``: EfficientNet-B0 and
U2NETP with BatchNorm statistics measured on seeded images) and the same batch
go through one training step on each side, in float64 (``jax.enable_x64``, the
flax modules built with ``dtype=float64``; the port's models in float64): the
loss, each gradient tensor, the BatchNorm statistics the step leaves (flax's
momentum update with the batch's biased variance), the parameters after one
Adam step, and ``recalibrate_batch_stats`` over two batches.  The JAX side is
the JAX package's own ``ClassifierFinetuner._step`` / ``UNetFinetuner._step``,
run once with ``optax.sgd(1)`` in place of Adam so that its update is the
gradient; ``optax.adam``'s update of that gradient gives the Adam step.  The
classifier's head dropout is set to 0 on both sides (the two draw their masks
from different generators), by patching each package's ``_CFG`` table here.

Limits: the loss 1e-6 relative (both round the logits, or the side outputs, to
fp32 where the loss starts, as the JAX package does); each gradient
‖g_port − g_jax‖ ≤ 1e-4 · ‖g_jax‖ + 1e-6 · ‖all of g_jax‖ (the second term for
BatchNorm biases followed by a train-mode BatchNorm, whose gradient vanishes but
for rounding); BatchNorm statistics 1e-8 relative; the port's Adam step within
1e-4 of ``optax.adam``'s on the same gradient, per tensor.  Against the JAX
step's parameters the move is held as ``tests/test_torch_train_cli.py`` holds
the tracker's: ‖Δp_port − Δp_jax‖ ≤ 1e-3 · ‖Δp_jax‖ + lr · 1e-2 · √n.  Adam
divides each gradient by its own magnitude, so an element whose gradient is of
the order of Adam's eps (1e-8) moves by a step of order lr that follows the
fp32 rounding of the logits (or the side outputs) where the loss starts: up to
a quarter of lr over a few dozen of a tensor's elements.  ``fit_arrays`` must hand
both packages' steps the same batches in the same order, and the port's
fine-tuners must learn the toy tasks of ``tests/test_finetune.py``.
"""

import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

from tests.torch_parity import classifier_images, seeded_classifier_variables, seeded_u2net_variables, unet_images
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.models import efficientnet as peff
from yolo_puncture_tpu_torch.train import finetune as pft
from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict, export_u2net_state_dict

S, LR = 64, 1e-3
LOSS_REL = 1e-6
GRAD_REL, GRAD_GLOBAL = 1e-4, 1e-6
ADAM_REL = 1e-4
MOVE_REL, MOVE_STEPS = 1e-3, 1e-2
STATS_REL = 1e-8
NO_DROPOUT = {"b0": (1.0, 1.0, 224, 0.0)}


def _cls_batch():
    return classifier_images(S, n=4), np.array([0, 1, 1, 0], np.int32)


def _unet_batch():
    bgr = unet_images(S, S, n=2)
    images = bgr[..., ::-1].astype(np.float64) / 255.0
    masks = (bgr.max(-1) > 200).astype(np.float64)
    return images, masks


def _assert_close_trees(got: dict, ref: dict, what: str, rel: float, glob: float = 0.0):
    assert sorted(got) == sorted(ref), what
    total = np.sqrt(sum(float(np.sum(np.square(r))) for r in ref.values()))
    for k, r in ref.items():
        err = float(np.linalg.norm(got[k] - r))
        assert err <= rel * np.linalg.norm(r) + glob * total, (what, k, err, float(np.linalg.norm(r)))


def _assert_adam_moves(before: dict, grads: dict, got: dict, ref: dict):
    """The port's Adam move against ``optax.adam`` on the port's own gradient
    (ADAM_REL per tensor), and against the JAX step's move (MOVE_REL, MOVE_STEPS)."""
    import jax
    import optax

    with jax.enable_x64(True):
        adam = optax.adam(LR)
        updates, _ = adam.update(grads, adam.init(grads))
        want = {k: np.asarray(u) for k, u in updates.items()}
    for k, p0 in before.items():
        d_got, d_ref = got[k] - p0, ref[k] - p0
        assert np.linalg.norm(d_got - want[k]) <= ADAM_REL * np.linalg.norm(want[k]), k
        limit = MOVE_REL * np.linalg.norm(d_ref) + LR * MOVE_STEPS * np.sqrt(d_ref.size)
        assert np.linalg.norm(d_got - d_ref) <= limit, (k, float(np.linalg.norm(d_got - d_ref)), limit)


def _jax_step(ft, params, stats, *batch):
    """The JAX fine-tuner's jitted step with ``optax.sgd(1)``: (loss, gradient
    tree, new statistics), then the parameters after ``optax.adam(LR)``'s step."""
    import jax
    import optax

    ft.tx = optax.sgd(1.0)                       # read when the step is traced: its update is −gradient
    out = ft._step(params, stats, ft.tx.init(params), *batch)
    params1, stats1, loss = out[0], out[1], out[3]
    grads = jax.tree.map(lambda a, b: a - b, params, params1)
    adam = optax.adam(LR)
    updates, _ = adam.update(grads, adam.init(grads))
    return float(loss), jax.device_get(grads), jax.device_get(stats1), jax.device_get(optax.apply_updates(params,
                                                                                                         updates))


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_classifier():
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.models import efficientnet as jeff
    from yolo_puncture_tpu.train import finetune as jft

    crops, labels = _cls_batch()
    with jax.enable_x64(True), mock.patch.dict(jeff._CFG, NO_DROPOUT):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), seeded_classifier_variables("b0", S))
        model = jeff.EfficientNet(variant="b0", num_classes=2, dtype=jnp.float64)
        ft = jft.ClassifierFinetuner(types.SimpleNamespace(model=model, variables=v, input_size=S), lr=LR)
        loss, grads, stats1, params1 = _jax_step(ft, v["params"], v["batch_stats"], jnp.asarray(crops),
                                                  jnp.asarray(labels), jnp.asarray(0, jnp.int32))
        halves = [jeff.preprocess_classifier(jnp.asarray(crops[i:i + 2]), S, jnp.float64) for i in (0, 2)]
        recal = jax.device_get(jft.recalibrate_batch_stats(model, params1, v["batch_stats"], halves))
    return loss, grads, stats1, params1, recal


def _port_classifier():
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    with mock.patch.dict(peff._CFG, NO_DROPOUT):
        net = ClassifierNet("efficientnet_b0", input_size=S, variables=seeded_classifier_variables("b0", S),
                            device="cpu")
    net.model.double()
    net.model.dtype = torch.float64
    return net


def test_classifier_step_matches_jax():
    """One ``ClassifierFinetuner`` step on B0 at 64², batch 4: loss, gradients,
    BatchNorm statistics after the step, parameters after Adam."""
    loss_j, grads_j, stats_j, params_j, _ = _jax_classifier()
    net = _port_classifier()
    before = {k: v.detach().numpy().copy() for k, v in net.model.named_parameters()}
    ft = pft.ClassifierFinetuner(net, lr=LR)
    crops, labels = _cls_batch()
    loss, acc = ft.step(torch.from_numpy(crops), torch.from_numpy(labels))
    assert abs(float(loss) - loss_j) <= LOSS_REL * abs(loss_j), (float(loss), loss_j)
    assert 0.0 <= float(acc) <= 1.0
    grads = {k: p.grad.numpy() for k, p in net.model.named_parameters()}
    _assert_close_trees(grads, export_classifier_state_dict({"params": grads_j}), "gradient", GRAD_REL, GRAD_GLOBAL)
    sd = net.model.state_dict()
    ref_stats = export_classifier_state_dict({"params": {}, "batch_stats": stats_j})
    _assert_close_trees({k: sd[k].numpy() for k in ref_stats}, ref_stats, "statistics after the step", STATS_REL)
    after = {k: v.detach().numpy() for k, v in net.model.named_parameters()}
    _assert_adam_moves(before, grads, after, export_classifier_state_dict({"params": params_j}))


def test_classifier_recalibration_matches_jax():
    """``recalibrate_batch_stats`` over two batches of 2 after the Adam step, on
    the weights of that step, against the JAX two-pass solver."""
    *_, params_j, recal_j = _jax_classifier()
    net = _port_classifier()
    ref = export_classifier_state_dict({"params": params_j, "batch_stats": recal_j})
    net.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, strict=False)
    crops, _ = _cls_batch()
    got = pft.recalibrate_batch_stats(net.model, [
        peff.preprocess_classifier(torch.from_numpy(crops[i:i + 2]), S, torch.float64) for i in (0, 2)])
    ref_stats = export_classifier_state_dict({"params": {}, "batch_stats": recal_j})
    assert sorted(got) == sorted(ref_stats) and not net.model.training
    _assert_close_trees({k: v.numpy() for k, v in got.items()}, ref_stats, "recalibrated statistics", STATS_REL)


# ---------------------------------------------------------------------------
# U²-Net
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_unet():
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.models.u2net import U2Net as JaxU2Net
    from yolo_puncture_tpu.train import finetune as jft

    images, masks = _unet_batch()
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), seeded_u2net_variables(True, unet_images(S, S)))
        model = JaxU2Net(small=True, dtype=jnp.float64)
        ft = jft.UNetFinetuner(types.SimpleNamespace(model=model, variables=v), lr=LR)
        loss, grads, stats1, params1 = _jax_step(ft, v["params"], v["batch_stats"], jnp.asarray(images),
                                                  jnp.asarray(masks))
        recal = jax.device_get(jft.recalibrate_batch_stats(model, params1, v["batch_stats"],
                                                           [jnp.asarray(images[:1]), jnp.asarray(images[1:])]))
    return loss, grads, stats1, params1, recal


def _port_unet(variables):
    from yolo_puncture_tpu_torch.tasks import UNetPredictor

    pred = UNetPredictor("u2netp", device="cpu")
    pred.model.double()
    pred.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                                export_u2net_state_dict(variables).items()}, strict=False)
    return pred


def test_unet_step_matches_jax():
    """One ``UNetFinetuner`` step on U2NETP at 64², batch 2: the sum of the seven
    BCE terms, gradients, BatchNorm statistics after the step (momentum 0.9),
    parameters after Adam."""
    loss_j, grads_j, stats_j, params_j, _ = _jax_unet()
    pred = _port_unet(seeded_u2net_variables(True, unet_images(S, S)))
    before = {k: v.detach().numpy().copy() for k, v in pred.model.named_parameters()}
    ft = pft.UNetFinetuner(pred, lr=LR)
    images, masks = _unet_batch()
    loss = ft.step(torch.from_numpy(images), torch.from_numpy(masks))
    assert abs(float(loss) - loss_j) <= LOSS_REL * abs(loss_j), (float(loss), loss_j)
    grads = {k: p.grad.numpy() for k, p in pred.model.named_parameters()}
    _assert_close_trees(grads, export_u2net_state_dict({"params": grads_j}), "gradient", GRAD_REL, GRAD_GLOBAL)
    sd = pred.model.state_dict()
    ref_stats = export_u2net_state_dict({"params": {}, "batch_stats": stats_j})
    _assert_close_trees({k: sd[k].numpy() for k in ref_stats}, ref_stats, "statistics after the step", STATS_REL)
    after = {k: v.detach().numpy() for k, v in pred.model.named_parameters()}
    _assert_adam_moves(before, grads, after, export_u2net_state_dict({"params": params_j}))


def test_unet_recalibration_matches_jax():
    *_, params_j, recal_j = _jax_unet()
    pred = _port_unet({"params": params_j, "batch_stats": recal_j})
    images, _ = _unet_batch()
    got = pft.recalibrate_batch_stats(pred.model, [torch.from_numpy(images[i:i + 1]).permute(0, 3, 1, 2)
                                                   for i in (0, 1)])
    ref_stats = export_u2net_state_dict({"params": {}, "batch_stats": recal_j})
    _assert_close_trees({k: v.numpy() for k, v in got.items()}, ref_stats, "recalibrated statistics", STATS_REL)


def test_recalibrate_batch_stats_exact():
    """Each layer's statistics are the weighted mean of its true batch statistics,
    whatever its momentum (the port's copy of the JAX test)."""
    from yolo_puncture_tpu_torch.nn.common import BatchNorm2d

    m = torch.nn.Sequential(BatchNorm2d(5, momentum=0.07), BatchNorm2d(5, momentum=0.01)).double()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((12, 5, 3, 2)) * 3.0 + 2.0)
    got = pft.recalibrate_batch_stats(m, [x[:8], x[8:]])
    xs = x.permute(1, 0, 2, 3).reshape(5, -1).numpy()
    parts = [x[:8].permute(1, 0, 2, 3).reshape(5, -1).numpy(), x[8:].permute(1, 0, 2, 3).reshape(5, -1).numpy()]
    np.testing.assert_allclose(got["0.running_mean"].numpy(), xs.mean(1), rtol=1e-12)
    np.testing.assert_allclose(got["0.running_var"].numpy(), (8 * parts[0].var(1) + 4 * parts[1].var(1)) / 12,
                               rtol=1e-12)
    # the second layer sees each batch normalised by that batch's own statistics: mean 0, variance ≈ 1
    np.testing.assert_allclose(got["1.running_mean"].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(got["1.running_var"].numpy(), 1.0, rtol=1e-4)


# ---------------------------------------------------------------------------
# fit_arrays visits the same batches
# ---------------------------------------------------------------------------


def _recording_fit(monkeypatch, jax_ft, port_ft, jax_mod, arrays, batch_size, epochs):
    """Run both ``fit_arrays`` with the steps and the recalibration replaced by
    recorders; returns (JAX's steps, port's steps, JAX's recalibration batches,
    port's)."""
    seen = {"jax": [], "port": [], "jax_recal": [], "port_recal": []}

    def jax_step(params, stats, opt_state, *batch):
        seen["jax"].append([np.asarray(a) for a in batch])
        if hasattr(jax_ft, "net"):                       # the classifier's step also returns the accuracy
            return params, stats, opt_state, 0.0, 0.0
        return params, stats, opt_state, 0.0

    def port_step(*batch):
        seen["port"].append([a.numpy() for a in batch])
        return (torch.zeros(()), torch.zeros(())) if hasattr(port_ft, "net") else torch.zeros(())

    def recorder(key):
        def record(model, *args):
            seen[key].extend(np.asarray(b) for b in args[-1])
            return args[1] if len(args) > 1 else {}
        return record

    monkeypatch.setattr(jax_ft, "_step", jax_step)
    monkeypatch.setattr(port_ft, "step", port_step)
    monkeypatch.setattr(jax_mod, "recalibrate_batch_stats", recorder("jax_recal"))
    monkeypatch.setattr(pft, "recalibrate_batch_stats", recorder("port_recal"))
    jax_ft.fit_arrays(*arrays, epochs=epochs, batch_size=batch_size, log_every=0)
    port_ft.fit_arrays(*arrays, epochs=epochs, batch_size=batch_size, log_every=0)
    return seen


@pytest.mark.parametrize("which", ["classifier", "unet"])
def test_fit_arrays_visits_the_jax_batches(monkeypatch, which):
    """Three epochs over 10 items in batches of 4 (the last 2 dropped each
    epoch): the same items in the same order, then the same recalibration
    batches, on both sides."""
    from yolo_puncture_tpu.train import finetune as jft

    rng = np.random.default_rng(3)
    model = torch.nn.Linear(1, 1)
    model.dtype = torch.float32
    if which == "classifier":
        arrays = (rng.integers(0, 255, (10, 8, 8, 3), dtype=np.uint8), rng.integers(0, 2, 10).astype(np.int32))
        jax_ft = jft.ClassifierFinetuner(types.SimpleNamespace(model=None, variables={"params": {}}, input_size=8),
                                         seed=5)
        port_ft = pft.ClassifierFinetuner(types.SimpleNamespace(model=model, device=torch.device("cpu"),
                                                                input_size=8), seed=5)
    else:
        arrays = (rng.uniform(0, 1, (10, 8, 8, 3)).astype(np.float32), rng.uniform(0, 1, (10, 8, 8)) > 0.5)
        jax_ft = jft.UNetFinetuner(types.SimpleNamespace(model=None, variables={"params": {}}), seed=5)
        port_ft = pft.UNetFinetuner(types.SimpleNamespace(model=model, device=torch.device("cpu")), seed=5)
    stand_in = types.SimpleNamespace(model=types.SimpleNamespace(dtype=np.float32),
                                     variables={"params": {}, "batch_stats": {"bn": 1}}, input_size=8)
    setattr(jax_ft, "net" if which == "classifier" else "predictor", stand_in)
    seen = _recording_fit(monkeypatch, jax_ft, port_ft, jft, arrays, batch_size=4, epochs=3)
    assert len(seen["jax"]) == len(seen["port"]) == 6
    for j, p in zip(seen["jax"], seen["port"]):
        for a, b in zip(j, p):
            assert np.array_equal(a.astype(np.float64), b.astype(np.float64))
    assert len(seen["jax_recal"]) == len(seen["port_recal"]) == 2
    for a, b in zip(seen["jax_recal"], seen["port_recal"]):
        np.testing.assert_allclose(np.moveaxis(b, 1, -1), a, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the dataset reader
# ---------------------------------------------------------------------------


def test_load_cls_bbox_dataset_and_crops_match_jax(tmp_path):
    """The same items from a dataset of PNG and JPEG files (one label file
    missing, one too short), and the same crops."""
    import cv2

    from yolo_puncture_tpu.train.finetune import ClassifierFinetuner as JaxFt
    from yolo_puncture_tpu.train.finetune import load_cls_bbox_dataset as jax_load

    (tmp_path / "images" / "train").mkdir(parents=True)
    (tmp_path / "labels" / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (ext, label) in enumerate([(".png", "1 0.5 0.5 0.4 0.3"), (".jpg", "0 0.2 0.7 0.3 0.5"),
                                      (".png", None), (".png", "1 0.5"), (".PNG", "0.0 0.9 0.1 0.2 0.2"),
                                      (".txt", "1 0.5 0.5 0.1 0.1")]):
        img = rng.integers(0, 255, (48 + 8 * i, 64, 3)).astype(np.uint8)
        if ext == ".txt":                                   # not an image: skipped
            (tmp_path / "images" / "train" / f"{i}frame.txt").write_text("not an image")
        else:
            cv2.imwrite(str(tmp_path / "images" / "train" / f"{i}frame{ext.lower()}"), img)
        if ext == ".PNG":
            (tmp_path / "images" / "train" / f"{i}frame.png").rename(tmp_path / "images" / "train" / f"{i}frame.PNG")
        if label is not None:
            (tmp_path / "labels" / "train" / f"{i}frame.txt").write_text(label)
    items = pft.load_cls_bbox_dataset(str(tmp_path), "train")
    assert items == jax_load(str(tmp_path), "train") and [c for _, c, _ in items] == [1, 0, 0]
    crops, labels = pft.ClassifierFinetuner.crops_from_dataset(str(tmp_path), "train", 40)
    ref_crops, ref_labels = JaxFt.crops_from_dataset(str(tmp_path), "train", 40)
    assert crops.shape == (3, 40, 40, 3) and np.array_equal(crops, ref_crops) and np.array_equal(labels, ref_labels)


# ---------------------------------------------------------------------------
# the toy tasks of tests/test_finetune.py
# ---------------------------------------------------------------------------


def _toy_classifier_data(n=32, size=96):
    """class 1 = bright square present, class 0 = dark noise."""
    rng = np.random.default_rng(0)
    crops = rng.integers(0, 60, size=(n, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    for i in range(n):
        if labels[i] == 1:
            crops[i, 20:70, 20:70] = 230
    return crops, labels


def test_classifier_finetune_learns():
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    net = ClassifierNet("efficientnet_b0", input_size=96, device="cpu")
    crops, labels = _toy_classifier_data()
    ft = pft.ClassifierFinetuner(net, lr=5e-4)
    loss, acc = ft.fit_arrays(crops, labels, epochs=12, batch_size=16, log_every=0)
    assert loss is not None and loss < 0.4, f"CE did not drop: {loss}"
    idx, p = net.predict(crops[:16])
    train_acc = (idx == labels[:16]).mean()
    assert train_acc >= 0.8, f"classifier did not fit the toy task: {train_acc}"


def test_unet_finetune_learns():
    from yolo_puncture_tpu_torch.tasks import UNetPredictor

    rng = np.random.default_rng(0)
    n, s = 16, 48
    images = rng.uniform(0, 0.2, size=(n, s, s, 3)).astype(np.float32)
    masks = np.zeros((n, s, s), np.float32)
    for i in range(n):
        x = int(rng.integers(4, 20))
        images[i, 10:34, x:x + 20] = 0.9
        masks[i, 10:34, x:x + 20] = 1.0
    pred = UNetPredictor("u2netp", device="cpu")
    ft = pft.UNetFinetuner(pred, lr=3e-4)
    l0 = ft.fit_arrays(images, masks, epochs=1, batch_size=4, log_every=0)
    l1 = ft.fit_arrays(images, masks, epochs=6, batch_size=4, log_every=0)
    assert l1 < l0, f"U2Net loss did not drop: {l0} → {l1}"
    out = pred.predict((images[0][..., ::-1] * 255).astype(np.uint8))
    inter = ((out > 0) & (masks[0] > 0)).sum()
    union = ((out > 0) | (masks[0] > 0)).sum()
    assert union > 0 and inter / union > 0.3, f"U2Net IoU too low: {inter / union:.2f}"
