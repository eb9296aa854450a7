"""bf16 training of the detector's ``Trainer``: the rule of ``tests/test_torch_bf16_train.py``.

The network in train mode against the JAX package's ``YOLOModel(dtype=bfloat16)``
on fp32 parameters, the optimizer's step on fp32 masters, and the checkpoints of a
bf16 run.  Apart from the tracker's file so that the suite's workers share the
JAX compiles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tests.test_torch_bf16_train import (  # noqa: F401  (torch_single_thread: autouse fixture)
    BF16,
    GRAD_FLOOR,
    _hold_tree,
    assert_fp32_training_state,
    torch_single_thread,
)
from tests.torch_parity import write_seg_dataset
from yolo_puncture_tpu_torch.nn.common import MasterWeights


# ---------------------------------------------------------------------------
# the detector's Trainer
# ---------------------------------------------------------------------------

DET_KW = dict(nc=1, imgsz=64, lr0=0.02, warmup_steps=0, total_steps=10)   # no warm-up: lr 0.02 at step 0
HEAD_KEYS = ("box_feats", "cls_feats", "coeff_feats", "one2one_box_feats", "one2one_cls_feats")


def _head_cotangents(shapes, seed):
    """A seeded standard normal cotangent for each of the train-mode head's
    feature maps and the prototypes, channels last."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def _jax_head_outputs(out):
    return [o for k in HEAD_KEYS if k in out for o in out[k]] + [out["proto"]]


def _port_head_outputs(out):
    return [o.permute(0, 2, 3, 1) for k in HEAD_KEYS if k in out for o in out[k]] + [out["proto"]]


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolo10n-seg"])
def test_detector_bf16_train_forward_and_gradient_match_jax(name):
    """The detector trainer's bf16 network in train mode (BatchNorm on the batch's
    statistics) against the JAX package's ``YOLOModel(dtype=bfloat16)`` on fp32
    parameters, at 64² on the batch of ``tests/test_torch_train_detector.py``:
    the head's feature maps and prototypes by RULE, the BatchNorm statistics the
    forward leaves by RULE, and the gradient of a fixed random linear function of
    those maps by ``_hold_tree`` and RAN.  (The loss itself is not a measure of
    rounding here: the task-aligned assigner is discrete, and JAX's own bf16 step
    moves YOLOv10-n's class loss from 40.10 to 45.16 at this size:
    ``scripts/bf16_train_findings_torch.py``.)"""
    from tests.test_torch_train_detector import _batch, _variables
    from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLO
    from yolo_puncture_tpu_torch import create_model
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

    version = "v8" if "v8" in name else "v10"
    variables, images = _variables(version), _batch()["images"]

    def jax_run(dt, cots):
        jm = JaxYOLO(version=version, scale="n", nc=1, task="segment", dtype=dt)

        def f(params, cots):
            out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, images, train=True,
                                mutable=["batch_stats"])
            outs = [o.astype(jnp.float32) for o in _jax_head_outputs(out)]
            return sum((o * c).sum() for o, c in zip(outs, cots)), (outs, upd["batch_stats"])

        (_, (outs, stats)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"], cots)
        return (dict(enumerate(jax.device_get(outs))),
                export_yolo_state_dict({"params": {}, "batch_stats": jax.device_get(stats)}),
                export_yolo_state_dict({"params": jax.device_get(g)}))

    def port_run(dtype, cots=None):
        model = create_model(name, nc=1, dtype=dtype)
        load_yolo_state_dict(model, export_yolo_state_dict(variables))
        weights = MasterWeights(model)
        model.train()
        outs = [o.float() for o in _port_head_outputs(model(torch.from_numpy(images)))]
        if cots is None:
            cots = _head_cotangents([o.shape for o in outs], 70)
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
        weights.collect_grads()
        stats = {k: v.numpy() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        return (dict(enumerate(o.detach() for o in outs)), stats,
                {k: p.grad.numpy() for k, p in weights.named.items()}, cots)

    p32 = port_run(torch.float32)
    cots = p32[3]                                  # the maps' shapes, channels last, from the port's run
    p16, j32, j16 = port_run(BF16, cots), jax_run(jnp.float32, cots), jax_run(jnp.bfloat16, cots)
    _hold_tree(f"{name} head maps", p16[0], j16[0], j32[0], p32[0], 0.0)
    _hold_tree(f"{name} BatchNorm statistics", p16[1], j16[1], j32[1], p32[1], 0.0)
    _hold_tree(f"{name} gradients", p16[2], j16[2], j32[2], p32[2], GRAD_FLOOR)


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolo10n-seg"])
def test_detector_trainer_bf16_step_acts_on_fp32_masters(name):
    """Fault 1 in the detector's ``Trainer``: one ``train_step`` of a bf16 model
    (seeded fp32 weights loaded) starts from masters equal to the fp32 weights,
    and SGD acts on them in fp32: the masters move by the JAX trainer's optax
    chain at step 0 on their own gradient (weight decay on the ≥ 2-D weights,
    Nesterov momentum from zero: −lr·(1 + μ)·(g + wd·p)), the momentum buffers
    hold g + wd·p, the EMA the ramp's mix of the two, all fp32; the model's bf16
    weights are the masters rounded and its statistics fp32."""
    from tests.test_torch_train_detector import _batch, _variables
    from yolo_puncture_tpu_torch import create_model
    from yolo_puncture_tpu_torch.train import Trainer
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, load_yolo_state_dict

    variables = export_yolo_state_dict(_variables("v8" if "v8" in name else "v10"))
    model = create_model(name, nc=1, dtype=BF16)
    load_yolo_state_dict(model, variables)
    tr = Trainer(model, **DET_KW)
    state = tr.init_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = tr.train_step(state, _batch())
    assert np.isfinite(float(m["total"])) and m["lr"] == float(np.float32(DET_KW["lr0"]))
    lr, mu, wd = DET_KW["lr0"], 0.937, 5e-4
    d = float(np.float32(0.9999) * (1.0 - np.exp(np.float32(-1 / 2000.0))))
    for k, p in state.params.items():
        p0 = before[k].double()
        assert torch.equal(before[k], torch.from_numpy(variables[k])), k
        g = p.grad.double() + (wd * p0 if p0.dim() >= 2 else 0.0)
        want = p0 - lr * (1 + mu) * g
        tol = 2 ** -22 * float(want.abs().max()) + 1e-6 * lr * float(g.abs().max())
        assert float((p.detach().double() - want).abs().max()) <= tol, k
        assert float((state.opt_state[k].double() - g).abs().max()) <= 2 ** -22 * float(g.abs().max()), k
        ema = d * p0 + (1 - d) * p.detach().double()
        assert float((state.ema_params[k].double() - ema).abs().max()) <= 2 ** -22 * float(ema.abs().max()), k
    assert_fp32_training_state(tr.model, state.params, tr.opt, state.ema_params)
    assert all(v.dtype == torch.float32 for v in state.opt_state.values())


def test_bf16_detector_checkpoint_round_trips_in_fp32(tmp_path):
    """A bf16-trained detector's checkpoint holds fp32 leaves, its masters to the
    bit; ``load_checkpoint``, a resumed ``fit`` on a fresh bf16 model, a bf16
    ``YOLO`` built from the checkpoint's weights and ``yolo_cli val`` read them
    back (``fp32_value`` of the loaded model's weights is the checkpoint), and so
    does the JAX package's ``YOLO`` from their flax msgpack (``yolo_variables``):
    fp32 leaves equal to the checkpoint's."""
    from tests.test_torch_train_detector import _batch
    from yolo_puncture_tpu_torch import YOLO, create_model
    from yolo_puncture_tpu_torch.apps import yolo_cli
    from yolo_puncture_tpu_torch.nn.common import fp32_value
    from yolo_puncture_tpu_torch.train import Trainer

    class OneBatch:
        def batches(self, batch_size):
            yield _batch()

    torch.manual_seed(0)
    model = create_model("yolov8n-seg", nc=1, dtype=BF16)
    tr = Trainer(model, **DET_KW)
    state = tr.fit(OneBatch(), epochs=2, ckpt_dir=str(tmp_path / "run"), log_every=100)
    ck = Trainer.load_checkpoint(str(tmp_path / "run"))
    assert ck["step"] == 2
    for tree in ("params", "opt_state", "ema_params", "batch_stats"):
        assert all(v.dtype == torch.float32 for v in ck[tree].values()), tree
    for k, v in state.params.items():
        assert torch.equal(ck["params"][k], v.detach()), k
    fresh = create_model("yolov8n-seg", nc=1, dtype=BF16)
    tr2 = Trainer(fresh, **DET_KW)
    st2 = tr2.fit(OneBatch(), epochs=1, resume=str(tmp_path / "run"), log_every=100)
    assert st2.step == 3 and all(v.dtype == torch.float32 for v in st2.params.values())
    raw = tmp_path / "yolov8n-seg.pt"
    torch.save({**ck["params"], **ck["batch_stats"]}, raw)
    det = YOLO(str(raw), nc=1, dtype=BF16, device="cpu")
    live = dict(det.model.named_parameters())
    assert any(p.dtype == BF16 for p in live.values())
    for k, v in ck["params"].items():
        assert torch.equal(fp32_value(live[k]), v), k
    from yolo_puncture_tpu.predict.predictor import YOLO as JaxYOLO
    from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, write_msgpack, yolo_variables

    path = tmp_path / "yolov8n-seg.msgpack"
    write_msgpack(yolo_variables({**ck["params"], **ck["batch_stats"]}), str(path))
    jvars = export_yolo_state_dict(jax.device_get(JaxYOLO(str(path), nc=1).variables))
    for k, v in ck["params"].items():
        assert jvars[k].dtype == np.float32 and np.array_equal(jvars[k], v.numpy()), k
    data = tmp_path / "data"
    write_seg_dataset(data, n_train=2, n_val=2)
    yolo_cli.main(["val", f"data={data}", f"model={tmp_path / 'run'}", "arch=yolov8n-seg", "imgsz=64"], device="cpu")
