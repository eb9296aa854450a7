"""Detector training of the PyTorch port against the JAX package (``train/``).

The same seeded numpy inputs and JAX variables (``tests/torch_parity.py``)
go through the JAX package and the port: task-aligned assignment, the losses
and their gradients after a train-mode forward, the BatchNorm statistics that
forward leaves, one optimizer step of ``Trainer``, the data pipeline and mAP.

Tolerances.  The loss and its gradient are compared in float64 on both sides
(``jax.enable_x64``, the flax module built with ``dtype=float64``; the port's
model in float64), where the two implementations agree within 1.1e-6 in the
components and 1.4e-6 per gradient tensor: both round the head's maps to fp32
where the losses start, so that much fp32 remains.  In fp32 the same deep
train-mode network (BatchNorm on batch statistics, ~60 layers) turns 1e-7
differences into 2.3e-4 in the first layers' gradients, and the components of a
sum over 84 anchors differ by up to 1e-5: hence float64, for the optimizer step
too (``Trainer`` against the JAX trainer's optax chain applied to the JAX
gradient of the same batch).  Limits: components 1e-5
relative; each gradient ‖g_port − g_jax‖ ≤ 1e-4 · ‖g_jax‖ + 1e-6 · ‖all of g_jax‖
(the second term for BatchNorm biases followed by a train-mode BatchNorm, whose
gradient vanishes but for rounding); BatchNorm statistics 1e-8 relative in
float64; assignment indices and dataset batches exactly.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import port_model_from_jax, seeded_jax_variables, write_seg_dataset
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.train.assigner import task_aligned_assign
from yolo_puncture_tpu_torch.train.losses import detection_loss
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict

S, B, M = 64, 2, 4
COMPONENT_REL = 1e-5
GRAD_REL, GRAD_GLOBAL = 1e-4, 1e-6
STATS_REL = 1e-8


def _batch(seed=0):
    """Two 64² images (values k / 255, as the trainer ships them) with 2 and 3
    boxes of half to nine tenths of the image (the seeded head's boxes are wide:
    large boxes give positives at every level) and their rectangular masks at
    proto resolution."""
    rng = np.random.default_rng(seed)
    images = (rng.integers(0, 256, (B, S, S, 3)) / 255.0).astype(np.float32)   # lossless as uint8
    gt_bboxes = np.zeros((B, M, 4), np.float32)
    mask_gt = np.zeros((B, M), bool)
    gt_masks = np.zeros((B, M, S // 4, S // 4), np.float32)
    for b in range(B):
        for m in range(2 + b):
            x1, y1 = rng.uniform(0, S * 0.3, 2)
            w, h = rng.uniform(S * 0.5, S * 0.9, 2)
            gt_bboxes[b, m] = (x1, y1, min(x1 + w, S), min(y1 + h, S))
            mask_gt[b, m] = True
            q = gt_bboxes[b, m] / 4
            gt_masks[b, m, int(q[1]):int(np.ceil(q[3])), int(q[0]):int(np.ceil(q[2]))] = 1
    return dict(images=images, gt_labels=np.zeros((B, M), np.int32), gt_bboxes=gt_bboxes, mask_gt=mask_gt,
                gt_masks=gt_masks)


def _jax_model(version, dtype=None):
    from yolo_puncture_tpu.models.yolo import YOLOModel

    return YOLOModel(version=version, scale="n", nc=1, task="segment", **({"dtype": dtype} if dtype else {}))


@functools.lru_cache(maxsize=None)
def _variables(version, seed=2):
    import jax.numpy as jnp

    return seeded_jax_variables(_jax_model(version), jnp.zeros((1, S, S, 3)), seed=seed)


def _assert_grads(model, ref):
    total = np.sqrt(sum(float(np.sum(np.square(ref[n]))) for n, _ in model.named_parameters()))
    for name, p in model.named_parameters():
        r = ref[name]
        err = float(np.linalg.norm(p.grad.double().numpy() - r))
        assert err <= GRAD_REL * np.linalg.norm(r) + GRAD_GLOBAL * total, (name, err, float(np.linalg.norm(r)))


@functools.lru_cache(maxsize=None)
def _jax_float64(version):
    """The JAX package's train-mode forward, ``detection_loss`` and
    ``jax.value_and_grad`` in float64 on ``_batch()`` and ``_variables(version)``:
    (losses, gradient tree, new batch_stats tree)."""
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.train.losses import detection_loss as jax_loss

    batch = _batch()
    with jax.enable_x64(True):
        jm = _jax_model(version, jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _variables(version))

        def loss_fn(params, stats, b):
            out, upd = jm.apply({"params": params, "batch_stats": stats}, b["images"], train=True,
                                mutable=["batch_stats"])
            total, losses = jax_loss(out, b, nc=1)
            return total, (losses, upd["batch_stats"])

        b64 = dict(batch, images=batch["images"].astype(np.float64))
        (_, (jl, jstats)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"], jax.tree.map(jnp.asarray, b64))
        return {k: float(v) for k, v in jl.items()}, jax.device_get(jg), jax.device_get(jstats)


def _port_float64(version):
    model = port_model_from_jax(version, "n", 1, "segment", _variables(version)).double()
    model.dtype = torch.float64
    return model


@pytest.mark.parametrize("version", ["v8", "v10"])
def test_loss_gradients_and_batch_statistics_match_jax(version):
    """A train-mode forward, ``detection_loss`` (v10 with its one-to-one branch on
    detached features) and its gradient against ``jax.value_and_grad`` of the
    JAX package's, in float64; and the BatchNorm statistics after the forward
    against flax's ``batch_stats``: momentum 0.97 towards the batch's biased
    variance (``torch.nn.BatchNorm2d`` would take the unbiased one)."""
    jl, jg, jstats = _jax_float64(version)
    ref = export_yolo_state_dict({"params": jg, "batch_stats": jstats})
    batch64 = dict(_batch(), images=_batch()["images"].astype(np.float64))
    model = _port_float64(version)
    model.train()
    out = model(torch.from_numpy(batch64["images"]))
    if version == "v10":
        assert all(f.grad_fn is not None for f in out["one2one_box_feats"])
    total, losses = detection_loss(out, {k: torch.from_numpy(v) for k, v in batch64.items()}, nc=1)
    total.backward()
    assert sorted(losses) == sorted(jl)
    assert all(jl[k] > 0 for k in ("box", "cls", "dfl", "seg"))       # every term has positives
    for k, v in jl.items():
        got = float(losses[k].detach())
        assert abs(got - v) <= COMPONENT_REL * abs(v), (k, got, v)
    _assert_grads(model, ref)

    # at 64² the P5 layers see 2 × 2 × 2 = 8 values a channel: the unbiased variance would be 8/7 of this
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            r = ref[name]
            assert np.abs(t.numpy() - r).max() <= STATS_REL * np.abs(r).max(), name


def test_assigner_matches_jax_exactly_with_ties():
    """``task_aligned_assign`` on seeded boxes where anchors share scores and
    boxes (equal metrics: the top-k takes the lower index first), with a padded
    box and an anchor claimed by two boxes."""
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.train.assigner import task_aligned_assign as jax_assign
    from yolo_puncture_tpu_torch.nn.heads import make_anchors

    rng = np.random.default_rng(7)
    anchors, strides = make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    anc_px = (anchors * strides).numpy()
    A = anc_px.shape[0]
    scores = np.round(rng.uniform(0.05, 0.9, (3, A, 2)), 1).astype(np.float32)       # many equal scores
    half = rng.uniform(6, 20, (3, A, 2))
    boxes = np.concatenate([anc_px - half, anc_px + half], -1).astype(np.float32)
    boxes[:, 10:20] = boxes[:, 10:11]                                                  # equal boxes
    gt = np.array([[[4, 4, 40, 44], [20, 16, 60, 60], [0, 0, 64, 64], [0, 0, 0, 0]],
                   [[8, 8, 24, 56], [8, 8, 24, 56], [30, 2, 62, 30], [0, 0, 0, 0]],
                   [[0, 0, 1, 1], [2, 40, 62, 62], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    labels = np.array([[0, 1, 0, 0], [1, 1, 0, 0], [0, 1, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 0, 0]], bool)
    for topk in (10, 1):
        ref = jax.jit(jax_assign, static_argnames="topk")(*map(jnp.asarray, (scores, boxes, anc_px, labels, gt, mask)),
                                                          topk=topk)
        got = task_aligned_assign(*map(torch.from_numpy, (scores, boxes, anc_px, labels, gt, mask)), topk=topk)
        assert int(got["fg_mask"].sum()) > 5
        for key in ("fg_mask", "target_gt_idx", "target_labels"):
            assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
        for key in ("target_bboxes", "target_scores"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-7)


def test_trainer_step_matches_the_jax_trainer():
    """One ``Trainer.train_step`` of YOLOv10-n seg in float64 against the JAX
    package's ``Trainer`` optimizer chain (``Trainer.tx``: global-norm clip,
    weight decay on the ≥ 2-D weights, Nesterov SGD) applied to the JAX
    gradient of the same batch, its ``lr_schedule`` and the EMA ramp of its
    step: no warm-up (the lr at step 0 would be 0), the clip active, the images
    shipped as uint8.  The parameters' moves, the momentum buffers, the EMA, the
    step, the lr and the gradient norm, within the gradients' own agreement."""
    import jax
    import jax.numpy as jnp
    import optax

    from yolo_puncture_tpu.train.trainer import Trainer as JaxTrainer
    from yolo_puncture_tpu_torch.train import Trainer

    kw = dict(nc=1, imgsz=S, lr0=0.02, warmup_steps=0, total_steps=10, clip_norm=50.0)
    _, jg, jstats = _jax_float64("v10")
    jtr = JaxTrainer(_jax_model("v10"), **kw)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _variables("v10")["params"])
        # the chain is elementwise but for the global norm and the ≥ 2-D mask, so it runs on the
        # leaves packed into one 2-D and one 1-D vector: the same arithmetic, one small program
        # to compile in place of one over ~700 leaves
        leaves, treedef = jax.tree_util.tree_flatten(params)
        groups = [[i for i, a in enumerate(leaves) if (a.ndim >= 2) == wd] for wd in (True, False)]

        def pack(tree):
            ls = jax.tree_util.tree_leaves(tree)
            cat = [jnp.concatenate([ls[i].reshape(-1) for i in g]) for g in groups]
            return {"decayed": cat[0][:, None], "rest": cat[1]}

        def unpack(packed):                                   # on the host, in numpy
            out = [None] * len(leaves)
            for g, flat in zip(groups, (np.asarray(packed["decayed"])[:, 0], np.asarray(packed["rest"]))):
                for i, piece in zip(g, np.split(flat, np.cumsum([leaves[i].size for i in g])[:-1])):
                    out[i] = piece.reshape(leaves[i].shape)
            return jax.tree_util.tree_unflatten(treedef, out)

        @jax.jit
        def step(grads, params):
            grads, params = pack(grads), pack(params)
            updates, opt_state = jtr.tx.update(grads, jtr.tx.init(params), params)
            new_params = optax.apply_updates(params, updates)
            d = 0.9999 * (1.0 - jnp.exp(-1 / 2000.0))          # the trainer's EMA ramp at its first step
            ema = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), params, new_params)
            return new_params, opt_state[-1][0].trace, ema

        ref = {name: export_yolo_state_dict({"params": unpack(tree)})
               for name, tree in zip(("params", "momentum", "ema"), step(jg, params))}
        ref_norm, ref_lr = float(optax.global_norm(jg)), float(jtr.schedule(0))

    model = _port_float64("v10")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, **kw)
    state, m = tr.train_step(tr.init_state(), _batch())
    assert state.step == 1 and m["lr"] == ref_lr
    assert float(m["grad_norm"]) == pytest.approx(ref_norm, rel=1e-5) and ref_norm > 50.0     # the clip acted

    def close(got, want, name):
        err = float(np.linalg.norm(got - want))
        assert err <= GRAD_REL * float(np.linalg.norm(want)) + 1e-12, (name, err, float(np.linalg.norm(want)))

    for name, p in model.named_parameters():
        p0 = start[name].numpy()
        close(p.detach().numpy() - p0, ref["params"][name] - p0, name)
        close(state.opt_state[name].numpy(), ref["momentum"][name], name + " momentum")
        close(state.ema_params[name].numpy() - p0, ref["ema"][name] - p0, name + " ema")
    stats = export_yolo_state_dict({"params": {}, "batch_stats": jstats})
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert np.abs(t.numpy() - stats[name]).max() <= STATS_REL * np.abs(stats[name]).max(), name


def test_trainer_has_one_device_and_checkpoints_round_trip(tmp_path):
    from yolo_puncture_tpu_torch.train import Trainer
    from yolo_puncture_tpu_torch.train.trainer import latest_checkpoint, lr_schedule

    variables = _variables("v8", seed=5)
    model = port_model_from_jax("v8", "n", 1, "segment", variables)
    tr = Trainer(model, nc=1, imgsz=S, warmup_steps=2, total_steps=6)
    assert tr.mesh is None and tr.is_writer           # one process (tests/test_torch_parallel*.py: with a mesh)
    state = tr.init_state()
    for _ in range(2):
        state, m = tr.train_step(state, _batch(seed=2))
    assert m["lr"] == pytest.approx(0.01 * 1 / 2)                      # the warm-up's second step
    path = tr.save_checkpoint(state, str(tmp_path))
    assert latest_checkpoint(str(tmp_path)) == path and path.endswith("step_2.pt")
    fresh = port_model_from_jax("v8", "n", 1, "segment", variables)
    tr2 = Trainer(fresh, nc=1, imgsz=S, warmup_steps=2, total_steps=6)
    s2 = tr2.restore(tr2.init_state(), Trainer.load_checkpoint(str(tmp_path)))
    assert s2.step == 2
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert n.endswith("num_batches_tracked") or torch.equal(a, b), n
    for n in state.opt_state:
        assert torch.equal(state.opt_state[n], s2.opt_state[n]) and torch.equal(state.ema_params[n], s2.ema_params[n])
    import jax.numpy as jnp

    from yolo_puncture_tpu.train.trainer import lr_schedule as jax_schedule

    for step in range(12):
        assert lr_schedule(0.01, 0.01, 10, 3)(step) == pytest.approx(float(jax_schedule(0.01, 0.01, 10, 3)(
            jnp.asarray(step))), rel=1e-6)


def test_compute_map_matches_jax():
    from yolo_puncture_tpu.train.metrics import box_iou_np as jbox
    from yolo_puncture_tpu.train.metrics import compute_map as jmap
    from yolo_puncture_tpu.train.metrics import mask_iou_np as jmask
    from yolo_puncture_tpu_torch.train.metrics import box_iou_np, compute_map, mask_iou_np

    rng = np.random.default_rng(3)
    preds, gts = [], []
    for i in range(5):
        n, g = int(rng.integers(0, 6)), int(rng.integers(0, 4))
        xy = rng.uniform(0, 40, (n + g, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (n + g, 2))], 1).astype(np.float32)
        masks = rng.uniform(size=(n + g, 16, 16)) > 0.5
        preds.append({"boxes": boxes[:n] + rng.normal(0, 2, (n, 4)), "scores": rng.uniform(size=n),
                      "classes": rng.integers(0, 2, n).astype(np.float32), "masks": masks[:n]})
        gts.append({"boxes": boxes[n:], "classes": rng.integers(0, 2, g).astype(np.float32), "masks": masks[n:]})
    for use_masks in (False, True):
        assert compute_map(preds, gts, use_masks=use_masks) == jmap(preds, gts, use_masks=use_masks)
    assert compute_map([], []) == jmap([], [])
    a, b = preds[1]["boxes"], gts[2]["boxes"]
    assert np.array_equal(box_iou_np(a, b), jbox(a, b))
    assert np.array_equal(mask_iou_np(preds[1]["masks"], gts[2]["masks"]), jmask(preds[1]["masks"], gts[2]["masks"]))


@pytest.mark.parametrize("augment", [True, False])
def test_seg_dataset_batches_equal_the_jax_packages(tmp_path, augment):
    """The same seed gives the same batches, bit for bit: mosaic, the affine,
    flip and HSV jitter drawn in the same order; PNGs read and letterbox-resized
    without cv2 on the port's side."""
    from yolo_puncture_tpu.train.data import SegDataset as JaxDataset
    from yolo_puncture_tpu_torch.train.data import SegDataset

    root = write_seg_dataset(tmp_path)
    kw = dict(imgsz=64, max_boxes=4, augment=augment, seed=3, mosaic=0.5)
    ref, got = JaxDataset(str(root), **kw), SegDataset(str(root), **kw)
    assert len(got) == len(ref) == 5
    for _ in range(2):                                    # two epochs: the generator carries on
        for bg, br in zip(got.batches(2), ref.batches(2)):
            assert sorted(bg) == sorted(br)
            for k in br:
                assert bg[k].dtype == br[k].dtype and np.array_equal(bg[k], br[k]), k
    for i in range(2):
        for k, v in JaxDataset(str(root), split="val", imgsz=64).load(i, flip=i == 1).items():
            assert np.array_equal(SegDataset(str(root), split="val", imgsz=64).load(i, flip=i == 1)[k], v), k
