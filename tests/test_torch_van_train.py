"""One ``ClassifierFinetuner`` step on the port's ``van_b0`` against the JAX package's.

As ``tests/test_torch_finetune.py`` holds B0's (its helpers and limits): float64
on both sides, the JAX package's jitted step run with ``optax.sgd(1)`` so that its
update is the gradient; the loss 1e-6 relative, each gradient 1e-4 of its norm
(+ 1e-6 of the whole), the BatchNorm statistics after the step 1e-8, the Adam
step 1e-4 of ``optax.adam``'s.  Weights: ``seeded_classifier_variables("b0", 64,
family="van")``.  Apart from ``tests/test_torch_van.py`` because the JAX float64
step compiles for about a minute.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_finetune import LR, _assert_adam_moves, _assert_close_trees, _cls_batch, _jax_step
from tests.torch_parity import seeded_classifier_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu.models import van as jvan
from yolo_puncture_tpu_torch.utils.convert import export_classifier_state_dict

S = 64


def test_finetuner_step_matches_jax():
    """One ``ClassifierFinetuner`` step on ``van_b0`` at 64², batch 4, in float64 on
    both sides (the JAX package's jitted step with ``optax.sgd(1)``): loss, every
    gradient, the BatchNorm statistics after the step, the parameters after Adam.
    VAN has no dropout: the port's ``forward`` takes the fine-tuner's generator and
    ignores it."""
    from yolo_puncture_tpu.train import finetune as jft
    from yolo_puncture_tpu_torch.tasks import ClassifierNet
    from yolo_puncture_tpu_torch.train import finetune as pft

    from yolo_puncture_tpu.models import efficientnet as jeff

    crops, labels = _cls_batch()
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), seeded_classifier_variables("b0", S, family="van"))
        jmodel = jvan.VAN(variant="b0", num_classes=2, dtype=jnp.float64)
        # the step's input preprocessed eagerly, where it equals the port's bit for bit: jitted, XLA folds
        # the divisions by constants into products with their fp32 reciprocals, which moves the first
        # BatchNorm's batch mean by ~1e-8 of itself
        x = jeff.preprocess_classifier(jnp.asarray(crops), S, jnp.float64)
        with mock.patch.object(jeff, "preprocess_classifier", lambda *a: x):
            ft = jft.ClassifierFinetuner(types.SimpleNamespace(model=jmodel, variables=v, input_size=S), lr=LR)
        loss_j, grads_j, stats_j, params_j = _jax_step(ft, v["params"], v["batch_stats"], jnp.asarray(crops),
                                                       jnp.asarray(labels), jnp.asarray(0, jnp.int32))
    net = ClassifierNet("van_b0", input_size=S, variables=seeded_classifier_variables("b0", S, family="van"),
                        device="cpu")
    net.model.double()
    net.model.dtype = torch.float64
    before = {k: p.detach().numpy().copy() for k, p in net.model.named_parameters()}
    loss, _ = pft.ClassifierFinetuner(net, lr=LR).step(torch.from_numpy(crops), torch.from_numpy(labels))
    assert abs(float(loss) - loss_j) <= 1e-6 * abs(loss_j), (float(loss), loss_j)
    grads = {k: p.grad.numpy() for k, p in net.model.named_parameters()}
    _assert_close_trees(grads, export_classifier_state_dict({"params": grads_j}), "gradient", 1e-4, 1e-6)
    sd = net.model.state_dict()
    ref_stats = export_classifier_state_dict({"params": {}, "batch_stats": stats_j})
    _assert_close_trees({k: sd[k].numpy() for k in ref_stats}, ref_stats, "statistics after the step", 1e-8)
    after = {k: p.detach().numpy() for k, p in net.model.named_parameters()}
    _assert_adam_moves(before, grads, after, export_classifier_state_dict({"params": params_j}))
