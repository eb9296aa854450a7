"""The port's ``parallel/mesh.py`` against the JAX package's, and ``Trainer(mesh=)``.

Four gloo ranks on the CPU, one torch thread each, are spawned once for the
module (``ranks``): they run every case of ``tests/torch_parallel_ranks.py
mesh_cases`` and each test reads its part.  While they run, this process
compiles and runs JAX's mesh step.  The counterparts of
``tests/test_parallel.py`` (mesh shapes 4×1 and 2×2, ``shard_batch``,
``replicate``, the ``param_shardings`` rule, the column-parallel product), the
kernels ``param_shardings(min_size=2**14)`` selects on YOLOv10-n and -S against
JAX's selection by name, and one step of ``Trainer`` on YOLOv8-n seg at 64² and
a global batch of 4:

  * 4×1 against the JAX ``Trainer(mesh=make_mesh((4, 1)))`` step on four of
    conftest's eight virtual devices, the same exported weights and batch, in
    float64 on both sides at ``tests/test_torch_train_detector.py``'s
    tolerances: losses 1e-5 relative, the parameters' moves 1e-4;
  * 4×1 and 2×2 (the kernels of ``min_size=2**14`` split over ``model``)
    against the port's single-process step on the global batch, float64,
    within ``DP_REL`` (1e-10) of each tensor's largest value: losses,
    parameters, momentum, EMA, BatchNorm statistics, and in 2×2 the split
    weights' gradients (a reducing gather backward would double them);
  * the naive per-rank step (each rank's batch alone, per-rank BatchNorm,
    gradients averaged, as ``DistributedDataParallel`` does), computed here, at
    least 1000 × ``DP_REL`` away from the global step;
  * the loss of a float64 model is float64 (the one departure from the JAX
    package's loss arithmetic, which the 1e-10 comparisons need).
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as tpr
from tests.torch_parity import seeded_jax_variables
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from yolo_puncture_tpu_torch.utils.convert import export_yolo_state_dict, yolo_flax_path_to_torch_key

DP_REL = 1e-10
COMPONENT_REL, MOVE_REL = 1e-5, 1e-4
RANK_TIMEOUT = 300.0


def _jax_model(version="v8", scale="n", dtype=None):
    from yolo_puncture_tpu.models.yolo import YOLOModel

    return YOLOModel(version=version, scale=scale, nc=1, task="segment", **({"dtype": dtype} if dtype else {}))


@functools.lru_cache(maxsize=None)
def _variables():
    import jax.numpy as jnp

    return seeded_jax_variables(_jax_model(), jnp.zeros((1, tpr.S, tpr.S, 3)), seed=2)


@pytest.fixture(scope="module")
def ranks():
    from yolo_puncture_tpu_torch.parallel.mesh import spawn_ranks

    state = export_yolo_state_dict(_variables())
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        res = pool.submit(spawn_ranks, tpr.mesh_cases, 4, (state,), timeout=RANK_TIMEOUT, threads=1)
        _jax_mesh_step()
        return res.result()


def test_make_mesh_shapes(ranks):
    for r, res in enumerate(ranks):
        assert res["shapes"] == [{"data": 4, "model": 1}, {"data": 2, "model": 2}]
        assert res["coordinates"] == [{"data": r, "model": 0}, {"data": r // 2, "model": r % 2}]


def test_shard_batch_places_leading_dim(ranks):
    x, y = np.arange(16 * 4, dtype=np.float32).reshape(16, 4), torch.arange(16)
    for r, res in enumerate(ranks):
        s41, s22 = res["slices"]["4x1"], res["slices"]["2x2"]
        assert np.array_equal(s41["x"], x[4 * r:4 * r + 4]) and torch.equal(s41["y"], y[4 * r:4 * r + 4])
        d = r // 2                                                # the two 'model' ranks of a group: one slice
        assert np.array_equal(s22["x"], x[8 * d:8 * d + 8]) and torch.equal(s22["y"], y[8 * d:8 * d + 8])
        assert res["uneven_raised"]


def test_replicate(ranks):
    for res in ranks:                                             # ranks started at 1, 2, 3, 4
        assert torch.equal(res["replicated"]["w"], torch.full((3,), 1.0)) and res["replicated"]["in_place"]
        assert torch.equal(res["replicated"]["i"], torch.full((2,), 1))


def test_param_shardings_splits_large_kernels(ranks):
    """``test_parallel.py``'s three shapes in torch's layout (``(O, I, kh, kw)``):
    the output channels are dim 0, and dim 1 of a transposed convolution."""
    for res in ranks:
        assert res["rule"] == {"big": "Shard(dim=0)", "small": "Replicate()", "vec": "Replicate()"}
        assert res["rule_transposed"] == {"0.weight": "Shard(dim=1)", "0.bias": "Replicate()",
                                          "1.weight": "Replicate()", "1.bias": "Replicate()"}


@pytest.mark.parametrize("scale", ["n", "s"])
def test_param_shardings_selects_the_jax_kernels(ranks, scale):
    """On YOLOv10 seg the port selects by name exactly the kernels JAX's
    ``param_shardings(make_mesh((4, 2)), params, min_size=2**14)`` splits (YOLOv10-S's
    two 7×7 depthwise kernels of 512 channels among them)."""
    import jax
    import jax.numpy as jnp
    from jax.tree_util import DictKey

    from yolo_puncture_tpu.parallel.mesh import make_mesh, param_shardings

    shapes = jax.eval_shape(_jax_model("v10", scale).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    sh = param_shardings(make_mesh((4, 2)), shapes["params"], min_size=2 ** 14)
    want = sorted(yolo_flax_path_to_torch_key([k.key for k in path[:-1] if isinstance(k, DictKey)], path[-1].key)
                  for path, s in jax.tree_util.tree_flatten_with_path(sh)[0] if "model" in s.spec)
    got = ranks[0]["selected"][scale]
    assert got == want and len(got) == {"n": 54, "s": 78}[scale]
    if scale == "s":
        assert "model.8.m.0.cv1.2.conv.conv.weight" in got                 # depthwise: its groups split


def test_column_parallel_product_equals_the_plain_one(ranks):
    """JAX's ``x @ w`` with x on 'data' and w on 'model' (8 · 256 · 512), and each
    split layer (a convolution, a depthwise one, a transposed one, a linear layer)
    on 2×2: its output and input gradient equal the plain layer's on the rank's
    shard, half of its output channels get a gradient on each rank, and the
    gradients summed over every rank equal the plain layer's."""
    for res in ranks:
        assert res["ones_product"] == 8 * 256 * 512
        for name in ("conv", "grouped", "transposed", "linear"):
            c = res[f"split_{name}"]
            assert max(c["out"], c["dx"], c["dw"]) <= 1e-12 * max(c["scale"], 1.0), (name, c)
            assert c["grad_rows"] == c["out_channels"] // 2, (name, c)


@functools.lru_cache(maxsize=None)
def _jax_mesh_step():
    """JAX's ``Trainer(mesh=make_mesh((4, 1)))`` step in float64 from the seeded
    variables: (losses, new params, momentum, EMA, BatchNorm statistics) as state dicts."""
    import jax
    import jax.numpy as jnp

    from yolo_puncture_tpu.parallel.mesh import make_mesh
    from yolo_puncture_tpu.train.trainer import Trainer as JaxTrainer
    from yolo_puncture_tpu.train.trainer import TrainState

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _variables())
        tr = JaxTrainer(_jax_model(dtype=jnp.float64), mesh=make_mesh((4, 1), devices=jax.devices()[:4]),
                        **tpr.TRAINER_KW)
        state = TrainState(params=v64["params"], batch_stats=v64["batch_stats"], opt_state=tr.tx.init(v64["params"]),
                           step=jnp.zeros((), jnp.int32), ema_params=jax.tree.map(jnp.copy, v64["params"]))
        new, m = tr.train_step(state, tpr.global_batch())
        host = jax.device_get({"params": new.params, "momentum": new.opt_state[-1][0].trace, "ema": new.ema_params,
                               "stats": new.batch_stats})
    out = {k: export_yolo_state_dict({"params": t}) for k, t in host.items() if k != "stats"}
    out["stats"] = export_yolo_state_dict({"params": {}, "batch_stats": host["stats"]})
    out["losses"] = {k: float(v) for k, v in m.items()}
    return out


def test_mesh_step_matches_the_jax_mesh_step(ranks):
    """The port's 4×1 step against JAX's mesh step: the losses, lr and gradient
    norm within 1e-5, each parameter's and EMA's move and each momentum buffer
    within 1e-4 of JAX's (the tolerances of the single-process comparison), the
    BatchNorm statistics within 1e-8."""
    ref = _jax_mesh_step()
    got = ranks[0]["4x1_step"]
    assert sorted(got["losses"]) == sorted(ref["losses"])
    for k, v in ref["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=COMPONENT_REL), k
    assert ref["losses"]["grad_norm"] > tpr.TRAINER_KW["clip_norm"]                # the clip acted

    def close(a, b, what):
        err = float(np.linalg.norm(a - b))
        assert err <= MOVE_REL * float(np.linalg.norm(b)) + 1e-12, (what, err, float(np.linalg.norm(b)))

    for name, p0 in got["before"].items():
        p0 = p0.numpy()
        close(got["params"][name].numpy() - p0, ref["params"][name] - p0, name)
        close(got["momentum"][name].numpy(), ref["momentum"][name], name + " momentum")
        close(got["ema"][name].numpy() - p0, ref["ema"][name] - p0, name + " ema")
    for name, t in got["stats"].items():
        r = ref["stats"][name]
        assert np.abs(t.numpy() - r).max() <= 1e-8 * np.abs(r).max(), name


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_mesh_step_equals_the_single_process_step(ranks, layout):
    res = ranks[0]
    errors = res[f"{layout}_errors"]
    assert max(errors.values()) <= DP_REL, errors
    assert all(r[f"{layout}_same_as_rank0"] for r in ranks)
    split = res[f"{layout}_split"]
    assert bool(split) == (layout == "2x2")
    if split:
        # no doubled gradients: each split weight's gradient is the single process's (a zero one stays zero)
        grads = res["2x2_split_grads"]
        assert len(grads) >= len(split) and sum(ref > 0 for _, _, _, ref in grads.values()) > len(grads) // 2
        for name, (err, ref_max, norm, ref_norm) in grads.items():
            assert err <= DP_REL * ref_max and abs(norm - ref_norm) <= DP_REL * ref_norm, (name, grads[name])
        assert res["2x2_traffic"]["all_gather"] > 0
    assert res[f"{layout}_traffic"]["all_reduce"] > 0


def test_the_naive_per_rank_step_is_another_step(ranks):
    """The step ``DistributedDataParallel`` would take (each rank's batch alone
    with its own loss normalisers and BatchNorm statistics, the gradients
    averaged) against the global batch's: its losses and gradients at least
    1000 × ``DP_REL`` away, which the tests above would see."""
    from yolo_puncture_tpu_torch.train import Trainer

    state = export_yolo_state_dict(_variables())
    batch = tpr.global_batch()
    model = tpr.float64_model(state)
    tr = Trainer(model, **tpr.TRAINER_KW)
    tr.init_state()
    total, _ = tr.loss_and_grads(tr._to_device(batch))
    total = float(total.detach())
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    naive, naive_total = {n: torch.zeros_like(g) for n, g in grads.items()}, 0.0
    for k in range(4):
        m = tpr.float64_model(state)
        t = Trainer(m, **tpr.TRAINER_KW)
        t.init_state()
        loss, _ = t.loss_and_grads(t._to_device({key: v[k:k + 1] for key, v in batch.items()}))
        naive_total += float(loss.detach()) / 4
        for n, p in m.named_parameters():
            naive[n] += p.grad / 4
    worst = max(float((naive[n] - g).abs().max() / g.abs().max()) for n, g in grads.items() if g.abs().max() > 0)
    assert worst >= 1000 * DP_REL and abs(naive_total - total) >= 1000 * DP_REL * abs(total)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree


def test_the_loss_of_a_float64_model_is_float64():
    """``train/losses.py _wide``, the port's one departure from the JAX package's
    loss arithmetic (ROADMAP Queue 3): JAX takes the head's maps to fp32, the port
    to at least fp32.  So a float64 model's loss is float64, which the 1e-10
    comparisons above need (in fp32 the mesh step and the single process differ
    by the loss's fp32 sums, ~1e-7), and it equals the loss of the same maps in
    fp32, JAX's arithmetic, within ``COMPONENT_REL``.  fp32 and bf16 maps give an
    fp32 loss, as JAX's."""
    from yolo_puncture_tpu_torch.train.losses import detection_loss

    model = tpr.float64_model(export_yolo_state_dict(_variables()))
    batch = {k: torch.from_numpy(v) for k, v in tpr.global_batch().items()}
    with torch.no_grad():
        out = model.train()(batch["images"])
        losses = {dtype: detection_loss(_cast(out, dtype), batch, nc=1)[1]
                  for dtype in (torch.float64, torch.float32, torch.bfloat16)}
    for dtype, want in ((torch.float64, torch.float64), (torch.float32, torch.float32),
                        (torch.bfloat16, torch.float32)):
        assert all(v.dtype == want for v in losses[dtype].values()), dtype
    for k, v in losses[torch.float64].items():
        ref = float(losses[torch.float32][k])
        assert ref > 0 and abs(float(v) - ref) <= COMPONENT_REL * ref, (k, float(v), ref)
