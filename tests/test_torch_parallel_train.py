"""Data parallelism on the port's entry points: a bf16 ``Trainer(mesh=)``,
``yolo_cli train``'s rank function, and ``dryrun_multichip`` on gloo ranks on the CPU.

Two gloo ranks are spawned once for the module (``two_ranks``, in a thread, so
that this process computes the single-process runs meanwhile): they take the bf16
mesh step, then run ``yolo_cli train``'s rank function on a group of their own.

  * bf16: YOLOv8-n seg in bf16 (fp32 masters), unclipped, on two ranks against
    the port's single-process bf16 step on the same global batch.  The yardstick
    is bf16's own rounding: the single process on the batch in two other orders
    (the same step in exact arithmetic; on this batch its masters' gradients and
    moves differ by ~2 %).  The mesh step's losses, gradients and moves lie within
    ``BF16_SPREAD`` × the largest of those distances, its masters are fp32 and the
    same on both ranks.  Two wrong steps fall outside that limit: the naive
    per-rank step (``DistributedDataParallel``'s: each shard alone, gradients
    averaged), and the mesh step's gradients halved (a mean over the ranks where
    the sum is right).
  * ``yolo_cli train`` on two ranks (``train_rank``, the body each rank of a
    multi-card ``train`` runs, here over gloo): only rank 0 writes ``step_N.pt``,
    and the checkpoint equals the single-process ``train``'s in fp32: the
    BatchNorm statistics within 1e-5 of each tensor's largest value, the moves of
    the parameters, momentum and EMA from the seeded start as fp32 gradients
    agree (``MOVE_REL``: the smallest BatchNorm biases are their moves, and
    differ by 2.5e-4 of their largest value); the number of ranks follows the
    JAX CLI's rule.
  * ``dryrun_multichip(4, device="cpu")``: a 2×2 mesh, a finite loss, and the
    serving step's gathered boxes, scores, masks and accumulators equal to one
    process's ``video_step`` on the weights after the step.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as tpr
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import write_seg_dataset
from yolo_puncture_tpu_torch.parallel.mesh import free_port, spawn_ranks

RANK_TIMEOUT = 300.0
BF16_SPREAD = 1.5
CKPT_REL = 1e-5
# fp32 against fp32 over two steps of a deep train-mode network: the moves agree as gradients
# do, ``chip_smoke.py grads_match``'s limits (its CPU runs of two fp32 implementations differ by
# up to 2.3e-4 in a gradient tensor; these runs by 1.1e-4)
MOVE_REL, MOVE_GLOBAL = 2.3e-3, 1e-5
CLI_ARGS = ["model=yolov8n-seg", "epochs=1", "imgsz=64", "batch=2", "nc=1"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The data set of the CLI case and the future of the module's two ranks."""
    from yolo_puncture_tpu_torch.apps import yolo_cli

    root = tmp_path_factory.mktemp("cli")
    data = write_seg_dataset(root / "data")
    kv = yolo_cli.parse_kv(CLI_ARGS + [f"data={data}", f"project={root / 'dp'}"])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cli_init_method = f"tcp://127.0.0.1:{free_port()}"
        ranks = pool.submit(spawn_ranks, tpr.bf16_and_cli_ranks, 2, (cli_init_method, kv), timeout=RANK_TIMEOUT,
                            threads=1)
        yield {"root": root, "data": data, "ranks": ranks}
        ranks.result()


def _distance(ref, got, before=None):
    """Per parameter ‖got − ref‖ / ‖ref‖ (of the moves from ``before`` where given):
    (largest, median)."""
    rels = []
    for n, r in ref.items():
        g = got[n]
        if before is not None:
            g, r = g - before[n], r - before[n]
        if r.norm() > 0:
            rels.append(float((g - r).norm() / r.norm()))
    return max(rels), float(np.median(rels))


def test_bf16_mesh_step_is_within_bf16_rounding_of_one_process(two_ranks):
    batch = tpr.bf16_batch()
    sp = tpr.bf16_step(tpr.bf16_model(), batch)
    spread = {"grads": [], "moves": []}
    loss_spread = {k: 0.0 for k in sp["losses"]}
    for order in ([3, 2, 1, 0], [1, 0, 3, 2]):
        other = tpr.bf16_step(tpr.bf16_model(), {k: v[order] for k, v in batch.items()})
        spread["grads"].append(_distance(sp["grads"], other["grads"]))
        spread["moves"].append(_distance(sp["params"], other["params"], sp["before"]))
        for k, v in sp["losses"].items():
            loss_spread[k] = max(loss_spread[k], abs(other["losses"][k] - v))
    limit = {t: [BF16_SPREAD * max(s[i] for s in d) for i in range(2)] for t, d in spread.items()}
    naive = tpr.bf16_naive_grads(batch, 2)

    res = two_ranks["ranks"].result()
    assert all(r["same_as_rank0"] for r in res)
    dp = res[0]
    for n, p in dp["params"].items():
        assert p.dtype == torch.float32 and torch.equal(dp["before"][n], sp["before"][n]), n
    got = {"grads": _distance(sp["grads"], dp["grads"]), "moves": _distance(sp["params"], dp["params"], sp["before"])}
    for t in ("grads", "moves"):
        assert all(got[t][i] <= limit[t][i] for i in range(2)), (t, got, spread)
    for k, v in sp["losses"].items():
        assert abs(dp["losses"][k] - v) <= BF16_SPREAD * loss_spread[k] + 1e-7 * abs(v), (k, dp["losses"][k], v)

    # the limit sees a wrong step: DDP's naive one, and gradients averaged over the ranks instead of summed
    wrong = {"naive": _distance(sp["grads"], naive["grads"]),
             "halved": _distance(sp["grads"], {n: g / 2 for n, g in dp["grads"].items()})}
    for what, d in wrong.items():
        assert all(d[i] > 5 * limit["grads"][i] for i in range(2)), (what, d, limit)
    assert abs(naive["total"] - sp["losses"]["total"]) > 100 * BF16_SPREAD * loss_spread["total"]


def test_data_parallel_size_is_the_jax_rule():
    from yolo_puncture_tpu_torch.apps.yolo_cli import data_parallel_size

    for batch in range(1, 33):
        for n_dev in range(1, 9):
            jax_rule = max(d for d in range(1, n_dev + 1) if batch % d == 0 and d <= n_dev)
            assert data_parallel_size(batch, n_dev) == jax_rule
    assert data_parallel_size(16, 8) == 8 and data_parallel_size(12, 8) == 6 and data_parallel_size(7, 4) == 1


def test_yolo_cli_train_ranks_write_the_single_process_checkpoint(two_ranks):
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.apps import yolo_cli
    from yolo_puncture_tpu_torch.train import Trainer

    root = two_ranks["root"]
    yolo_cli.main(["train"] + CLI_ARGS + [f"data={two_ranks['data']}", f"project={root / 'sp'}"], device="cpu")
    assert [r["cli_step"] for r in two_ranks["ranks"].result()] == [2, 2]
    assert sorted(os.listdir(root / "dp")) == ["step_2.pt"]
    got, ref = Trainer.load_checkpoint(str(root / "dp")), Trainer.load_checkpoint(str(root / "sp"))
    assert got["step"] == ref["step"] == 2
    for n, r in ref["batch_stats"].items():
        assert (got["batch_stats"][n] - r).abs().max() <= CKPT_REL * r.abs().max(), n
    init = YOLO("yolov8n-seg", nc=1, device="cpu").model.state_dict()        # both runs' seeded start
    for tree in ("params", "opt_state", "ema_params"):
        assert sorted(got[tree]) == sorted(ref[tree])
        start = {n: init[n] if tree != "opt_state" else torch.zeros_like(r) for n, r in ref[tree].items()}
        moves = {n: (got[tree][n] - start[n], r - start[n]) for n, r in ref[tree].items()}
        total = float(torch.sqrt(sum((r.double() ** 2).sum() for _, r in moves.values())))
        for n, (g, r) in moves.items():
            assert (g - r).norm() <= MOVE_REL * r.norm() + MOVE_GLOBAL * total, (tree, n)


def test_dryrun_multichip_on_cpu_ranks():
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.parallel.dryrun import dryrun_frames, dryrun_multichip, video_step

    results = dryrun_multichip(4, device="cpu")
    r0 = results[0]
    assert r0["mesh"] == {"data": 2, "model": 2} and np.isfinite(r0["loss"])
    assert len(r0["split_layers"]) == 78 and all(r["backend"] == "gloo" for r in results)
    model = YOLO("yolo10s-seg", nc=1, seed=0, device="cpu").model
    model.load_state_dict(r0["state_dict"])
    model.eval()
    rng = np.random.default_rng(0)
    rng.uniform(size=(2, 64, 64, 3))                                      # the training batch's draw
    frames = torch.from_numpy(dryrun_frames(4, rng))
    acc = torch.zeros(4)
    for _ in range(2):
        boxes, scores, masks, acc = video_step(model, frames, acc)
    assert masks.shape == (4, 1, 16, 16) and bool(masks.any())
    for r in results:
        assert (r["boxes"] - boxes).abs().max() <= 1e-4 and (r["scores"] - scores).abs().max() <= 1e-6
        assert torch.equal(r["masks"], masks) and torch.allclose(r["acc"], acc, rtol=1e-5)
