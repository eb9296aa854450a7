"""Rank bodies of the parallel tests (``tests/test_torch_parallel*.py``).

Spawned processes import this module, so it imports torch, numpy and the port
only: no JAX.  Each body takes ``(rank, world_size, init_method, ...)`` as
``parallel/mesh.py spawn_ranks`` calls it, joins a gloo group on the CPU and
returns what the tests read.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

S, B, M = 64, 4, 4
TRAINER_KW = dict(nc=1, imgsz=S, lr0=0.02, warmup_steps=0, total_steps=10, clip_norm=50.0)
# no clip: a gradient summed where it should be averaged, or the reverse, moves the step
BF16_TRAINER_KW = dict(TRAINER_KW, clip_norm=0.0)
SPLIT_MIN_SIZE = 2 ** 14


def global_batch(seed: int = 0, n: int = B) -> dict:
    """``n`` 64² images with one to three boxes of half to nine tenths of the image
    and their rectangular masks at proto resolution.  The images are float64, so
    that the trainers of both packages feed them to a float64 model as they are
    (float32 images in [0, 1] go through uint8, and a jitted JAX step divides by
    255 as a product with fp32(1/255))."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, S, S, 3)) / 255.0
    gt_bboxes = np.zeros((n, M, 4), np.float32)
    mask_gt = np.zeros((n, M), bool)
    gt_masks = np.zeros((n, M, S // 4, S // 4), np.float32)
    for b in range(n):
        for m in range(1 + b % 3):
            x1, y1 = rng.uniform(0, S * 0.3, 2)
            w, h = rng.uniform(S * 0.5, S * 0.9, 2)
            gt_bboxes[b, m] = (x1, y1, min(x1 + w, S), min(y1 + h, S))
            mask_gt[b, m] = True
            q = gt_bboxes[b, m] / 4
            gt_masks[b, m, int(q[1]):int(np.ceil(q[3])), int(q[0]):int(np.ceil(q[2]))] = 1
    return dict(images=images, gt_labels=np.zeros((n, M), np.int32), gt_bboxes=gt_bboxes, mask_gt=mask_gt,
                gt_masks=gt_masks)


def float64_model(state: dict):
    """YOLOv8-n seg (one class) from an exported state dict, in float64."""
    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.utils.convert import load_yolo_state_dict

    model = YOLOModel("v8", "n", 1, "segment")
    load_yolo_state_dict(model, state)
    model = model.double()
    model.dtype = torch.float64
    return model


def trainer_step(model, batch, mesh=None, split: bool = False) -> dict:
    """One ``Trainer`` step (with ``mesh`` or without; ``split``: the kernels that
    ``param_shardings(min_size=2**14)`` picks split over ``model``): the losses,
    the state before and after, the momentum, the EMA, the gradients the
    optimizer used, the split layers."""
    from yolo_puncture_tpu_torch.parallel import mesh as pm
    from yolo_puncture_tpu_torch.train import Trainer

    tr = Trainer(model, mesh=mesh, **TRAINER_KW)
    state = tr.init_state()
    layers = pm.shard_model(mesh, model, pm.param_shardings(mesh, model, min_size=SPLIT_MIN_SIZE)) if split else []
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, m = tr.train_step(state, batch)
    return {"losses": {k: float(v) for k, v in m.items()},
            "before": before,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "stats": {k: v.clone() for k, v in state.batch_stats.items()},
            "momentum": {k: v.clone() for k, v in state.opt_state.items()},
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "grads": {k: v.grad.clone() for k, v in state.params.items()},
            "split_layers": layers, "split_params": sorted(pm.sharded_parameter_names(model))}


def rel_errors(got: dict, ref: dict) -> dict:
    """The largest of max |got − ref| / max |ref| over the tensors of each tree,
    and the largest relative loss difference."""
    out = {"losses": max(abs(got["losses"][k] - v) / abs(v) for k, v in ref["losses"].items() if v)}
    for tree in ("params", "stats", "momentum", "ema"):
        out[tree] = max(float((got[tree][n] - r).abs().max() / r.abs().max()) for n, r in ref[tree].items()
                        if r.abs().max() > 0)
    return out


def state_bits(model) -> torch.Tensor:
    return torch.cat([v.detach().reshape(-1).double() for v in model.state_dict().values() if v.is_floating_point()])


def same_as_rank0(model) -> bool:
    import torch.distributed as dist

    mine = state_bits(model)
    first = mine.clone()
    dist.broadcast(first, src=0)
    return bool(torch.equal(mine, first))


def mesh_cases(rank: int, world_size: int, init_method: str, state: dict) -> dict:
    """Every case of ``tests/test_torch_parallel.py`` on four gloo ranks."""
    import torch.distributed as dist
    from torch import nn

    from yolo_puncture_tpu_torch.models.yolo import YOLOModel
    from yolo_puncture_tpu_torch.parallel import mesh as pm
    from yolo_puncture_tpu_torch.parallel import (data_parallel_step, make_mesh, param_shardings, replicate,
                                                  shard_batch)

    out = {}
    with pm.process_group(rank, world_size, init_method, "gloo", "cpu"):
        m41, m22 = make_mesh(devices="cpu"), make_mesh((2, 2), devices="cpu")
        out["shapes"] = [m41.shape, m22.shape]
        out["coordinates"] = [m41.coordinate, m22.coordinate]

        arrays = {"x": np.arange(16 * 4, dtype=np.float32).reshape(16, 4), "y": torch.arange(16)}
        out["slices"] = {"4x1": shard_batch(m41, arrays), "2x2": shard_batch(m22, arrays)}
        try:
            shard_batch(m41, {"x": np.zeros((6, 2))})
            out["uneven_raised"] = False
        except ValueError:
            out["uneven_raised"] = True

        t, i = torch.full((3,), float(rank + 1)), torch.full((2,), rank + 1)
        got = replicate(m41, {"w": t, "more": [i]})
        out["replicated"] = {"w": t.clone(), "i": i.clone(), "in_place": got["w"] is t and got["more"][0] is i}

        kernels = {"big": torch.zeros(512, 256, 3, 3), "small": torch.zeros(16, 8, 3, 3), "vec": torch.zeros(128)}
        out["rule"] = {n: repr(p) for n, p in param_shardings(m22, kernels, min_size=2 ** 14).items()}
        up = nn.Sequential(nn.ConvTranspose2d(256, 512, 2, 2), nn.ConvTranspose2d(512, 6, 2, 2))
        out["rule_transposed"] = {n: repr(p) for n, p in param_shardings(m22, up, min_size=2 ** 14).items()}
        if rank == 0:
            out["selected"] = {}
            for scale in ("n", "s"):
                sh = param_shardings(m22, YOLOModel("v10", scale, 1, "segment"), min_size=SPLIT_MIN_SIZE)
                out["selected"][scale] = sorted(n for n, p in sh.items() if repr(p).startswith("Shard"))

        # the column-parallel product: JAX's sum of x @ w with x on 'data' and w on 'model', and a
        # split convolution's output and gradients against the plain layer's
        lin = nn.Linear(256, 512, bias=False)
        nn.init.ones_(lin.weight)
        pm.shard_model(m22, lin, param_shardings(m22, lin, min_size=2 ** 14))
        with m22:
            ones = m22.data_sum(lin(shard_batch(m22, torch.ones(8, 256))).sum())
        out["ones_product"] = float(ones.detach())
        torch.manual_seed(5)                         # the same layers on every rank
        g = torch.Generator().manual_seed(5)
        for name, layer, x_shape in (("conv", nn.Conv2d(16, 32, 3, padding=1), (4, 16, 5, 7)),
                                     ("grouped", nn.Conv2d(32, 32, 3, padding=1, groups=32), (4, 32, 5, 7)),
                                     ("transposed", nn.ConvTranspose2d(16, 8, 2, 2), (4, 16, 5, 7)),
                                     ("linear", nn.Linear(16, 24), (4, 16))):
            layer = layer.double()
            plain = copy.deepcopy(layer)
            pm.shard_model(m22, layer, param_shardings(m22, layer, min_size=1))
            x = torch.randn(x_shape, generator=g, dtype=torch.float64)
            xs, xp = shard_batch(m22, x).clone().requires_grad_(), x.clone().requires_grad_()
            ys, yp = layer(xs), plain(xp)
            w = torch.linspace(-1, 1, yp.numel(), dtype=torch.float64).reshape(yp.shape)
            (ys * shard_batch(m22, w)).sum().backward()
            (yp * w).sum().backward()
            local = layer.weight.grad.transpose(0, 1) if name == "transposed" else layer.weight.grad
            rows = int(local.flatten(1).abs().sum(1).gt(0).sum())               # output channels with a gradient here
            names, plain_params = dict(layer.named_parameters()), dict(plain.named_parameters())
            pm.reduce_gradients(m22, names, set(names))                          # slices summed over every rank
            out[f"split_{name}"] = {
                "out": float((ys - shard_batch(m22, yp)).abs().max()),
                "dx": float((xs.grad - shard_batch(m22, xp.grad)).abs().max()),
                "dw": max(float((p.grad - plain_params[n].grad).abs().max()) for n, p in names.items()),
                "scale": float(yp.abs().max()), "grad_rows": rows, "out_channels": local.shape[0]}

        # the data-parallel steps; rank 0 also runs the single-process step on the global batch
        batch = global_batch()
        ref = trainer_step(float64_model(state), batch) if rank == 0 else None
        for layout, mesh, split in (("4x1", m41, False), ("2x2", m22, True)):
            model = float64_model(state)
            got = trainer_step(model, batch, mesh=mesh, split=split)
            out[f"{layout}_same_as_rank0"] = same_as_rank0(model)
            out[f"{layout}_traffic"] = dict(mesh.traffic)
            if rank == 0:
                out[f"{layout}_errors"] = rel_errors(got, ref)
                out[f"{layout}_split"] = got["split_layers"]
                # per split parameter: max |Δ|, max |ref|, ‖got‖, ‖ref‖ of the gradient the optimizer used
                out[f"{layout}_split_grads"] = {
                    n: tuple(float(v) for v in ((got["grads"][n] - ref["grads"][n]).abs().max(),
                                                ref["grads"][n].abs().max(), got["grads"][n].norm(),
                                                ref["grads"][n].norm()))
                    for n in got["split_params"]}
                if layout == "4x1":
                    out["4x1_step"] = {k: got[k] for k in ("losses", "before", "params", "stats", "momentum", "ema")}

        # data_parallel_step with donate_state=False leaves the caller's state as it was
        def step_fn(st, local):
            st["x"] += torch.as_tensor(local).sum()
            return st, None

        st = {"x": torch.zeros(())}
        new, _ = data_parallel_step(m41, step_fn, donate_state=False)(st, np.arange(8.0))
        out["donated"] = (float(st["x"]), float(new["x"]))
        dist.barrier()
    return out


def bf16_model():
    """The seeded YOLOv8-n seg (one class) in bf16: fp32 values kept for its masters."""
    from yolo_puncture_tpu_torch import YOLO

    return YOLO("yolov8n-seg", nc=1, seed=0, device="cpu", dtype=torch.bfloat16).model


def bf16_batch() -> dict:
    """``global_batch(seed=2)`` in fp32.  Its step has no near-tie in the loss's
    discrete choices (the assigner's top 10, the mask loss's top 48 positives):
    bf16's rounding moves it by ~2 %.  ``seed=1``'s mask loss flips a choice under
    any change of summation order, a batch reordered in one process included, and
    its step moves by about a third."""
    return dict(global_batch(seed=2), images=global_batch(seed=2)["images"].astype(np.float32))


def bf16_step(model, batch, mesh=None) -> dict:
    """One ``Trainer`` step of a bf16 model, without clipping: the losses, and the
    fp32 masters before and after and their gradients."""
    from yolo_puncture_tpu_torch.train import Trainer

    tr = Trainer(model, mesh=mesh, **BF16_TRAINER_KW)
    state = tr.init_state()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, m = tr.train_step(state, batch)
    return {"losses": {k: float(v) for k, v in m.items()}, "before": before,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "grads": {k: v.grad.clone() for k, v in state.params.items()}}


def bf16_naive_grads(batch, n: int) -> dict:
    """The masters' gradients of the step ``DistributedDataParallel`` would take on
    ``n`` ranks: each shard alone (its own loss normalisers and BatchNorm
    statistics), the gradients averaged; and the ranks' mean total loss."""
    from yolo_puncture_tpu_torch.train import Trainer

    grads, total = {}, 0.0
    k = batch["images"].shape[0] // n
    for r in range(n):
        tr = Trainer(bf16_model(), **BF16_TRAINER_KW)
        state = tr.init_state()
        loss, _ = tr.loss_and_grads(tr._to_device(tr._quantize_for_transfer({key: v[r * k:(r + 1) * k]
                                                                              for key, v in batch.items()})))
        total += float(loss.detach()) / n
        for name, p in state.params.items():
            grads[name] = grads.get(name, 0) + p.grad / n
    return {"grads": grads, "total": total}


def bf16_and_cli_ranks(rank: int, world_size: int, init_method: str, cli_init_method: str, kv: dict) -> dict:
    """The two-rank cases of ``tests/test_torch_parallel_train.py`` on one spawn: a
    bf16 step on a (world_size, 1) mesh (rank 0 returns it), then ``yolo_cli
    train``'s rank function on a group of its own (``cli_init_method``)."""
    from yolo_puncture_tpu_torch.apps.yolo_cli import train_rank
    from yolo_puncture_tpu_torch.parallel import mesh as pm

    with pm.process_group(rank, world_size, init_method, "gloo", "cpu"):
        model = bf16_model()
        out = bf16_step(model, bf16_batch(), pm.make_mesh(devices="cpu"))
        out["same_as_rank0"] = same_as_rank0(model)
    if rank:
        out = {"same_as_rank0": out["same_as_rank0"]}
    out["cli_step"] = train_rank(rank, world_size, cli_init_method, kv, "gloo", "cpu")
    return out
