"""The DP×TP dry run: one sharded training step, then the multi-video serving step.

Counterpart of ``__graft_entry__.py dryrun_multichip``.  ``dryrun_multichip(n)``
starts ``n`` ranks (``parallel/mesh.py spawn_ranks``) on a mesh of ``(n/2, 2)``
for even ``n >= 4``, else ``(n, 1)``.  Each rank:

  * trains YOLOv10-S seg (seeded init, one class) one step with
    ``Trainer(mesh=)`` at 64², one sample per ``data`` shard, its large kernels
    split over ``model`` (``param_shardings(min_size=2**14)``, ``shard_model``);
  * serves ``V = 2·data`` videos of 72×96 uint8 frames sharded on ``data``:
    letterbox → forward (the same split kernels) → ``select_detections``
    (NMS-free top 4) → ``decode_masks(upsample=False, threshold=0.5)`` (the CUDA
    ``proto_decode`` kernel on the card) for two steps, a per-video accumulator of
    the first box's area carried on the rank that holds the video.

The ranks run on ``device`` (the card unless the caller asks for the CPU): one
card each over NCCL where there are ``n`` cards, else all on the first card, or
on the CPU, over gloo.  ``video_step`` is the serving step; a caller holds the
gathered outputs to ``video_step`` of one process on the returned weights.
"""

from __future__ import annotations

import numpy as np
import torch

S, M = 64, 4            # training and serving size, boxes a sample
FRAME_HW = (72, 96)
RANK_TIMEOUT_S = 900.0


def dryrun_batch(B: int, rng: np.random.Generator) -> dict:
    """``__graft_entry__.py``'s batch: uniform images, one 32² box and its mask a sample."""
    gt_masks = np.zeros((B, M, S // 4, S // 4), np.float32)
    gt_masks[:, 0, 4:12, 4:12] = 1.0
    return {
        "images": rng.uniform(size=(B, S, S, 3)).astype(np.float32),
        "gt_labels": np.zeros((B, M), np.int32),
        "gt_bboxes": np.tile(np.array([16.0, 16, 48, 48], np.float32), (B, M, 1)),
        "mask_gt": np.tile(np.array([True] + [False] * (M - 1)), (B, 1)),
        "gt_masks": gt_masks,
    }


@torch.no_grad()
def video_step(model, frames_u8: torch.Tensor, acc: torch.Tensor):
    """One serving step of a batch of one frame per video: (boxes (V, 4, 4),
    scores (V, 4), masks (V, 1, S/4, S/4), acc + the first box's area)."""
    from yolo_puncture_tpu_torch.ops.letterbox import letterbox
    from yolo_puncture_tpu_torch.ops.masks import decode_masks
    from yolo_puncture_tpu_torch.ops.nms import select_detections

    imgs, _, _ = letterbox(frames_u8, S, dtype=torch.float32, bgr_to_rgb=True)
    out = model(imgs)
    det = select_detections(out, nms_free=True, conf_thres=0.0, max_det=4)
    masks = decode_masks(out["proto"], det["coeffs"][:, :1], det["boxes"][:, :1], (S, S), upsample=False,
                         threshold=0.5)
    b = det["boxes"][:, 0]
    return det["boxes"], det["scores"], masks, acc + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def dryrun_frames(V: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 255, size=(V, *FRAME_HW, 3), dtype=np.uint8)


def _rank(rank: int, n: int, init_method: str, device_type: str, backend: str) -> dict:
    import torch.distributed as dist

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode
    from yolo_puncture_tpu_torch.parallel import mesh as pm
    from yolo_puncture_tpu_torch.train import Trainer

    device = torch.device("cuda", rank % torch.cuda.device_count()) if device_type == "cuda" else torch.device("cpu")
    with pm.process_group(rank, n, init_method, backend, device):
        mesh = pm.make_mesh((n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1), devices=device_type)
        model = YOLO("yolo10s-seg", nc=1, seed=0, device=device).model
        trainer = Trainer(model, nc=1, imgsz=S, total_steps=10, warmup_steps=0, mesh=mesh)
        rng = np.random.default_rng(0)
        B = mesh.shape["data"]                                   # one sample per data shard
        batch = dryrun_batch(B, rng)
        state = trainer.init_state(batch)
        split = pm.shard_model(mesh, model, pm.param_shardings(mesh, model, min_size=2 ** 14))
        state, metrics = trainer.train_step(state, batch)
        total = float(metrics["total"])
        if not np.isfinite(total) or state.step != 1:
            raise AssertionError(f"dry run step: loss {total}, step {state.step}")

        # the serving step: the batch carries one frame per video, so sharding it on 'data'
        # shards the videos; each video's accumulator lives on the rank of its frames
        V = 2 * B
        frames = torch.from_numpy(pm.shard_batch(mesh, dryrun_frames(V, rng))).to(device)
        acc = torch.zeros(frames.shape[0], dtype=torch.float32, device=device)
        model.eval()
        before = proto_decode.launches
        for _ in range(2):                                       # the accumulator carried over two steps
            boxes, scores, masks, acc = video_step(model, frames, acc)
        launches = proto_decode.launches - before
        outs = []
        for t in (boxes, scores, masks, acc):                    # gathered over 'data', in video order
            parts = [torch.empty_like(t) for _ in range(B)]
            dist.all_gather(parts, t.contiguous(), group=mesh.group("data"))
            outs.append(torch.cat(parts).cpu())
        return {"loss": total, "mesh": dict(mesh.shape), "coordinate": mesh.coordinate, "split_layers": split,
                "boxes": outs[0], "scores": outs[1], "masks": outs[2], "acc": outs[3],
                "proto_decode_launches": launches, "backend": dist.get_backend(),
                "device": str(device) if device.type == "cpu" else f"cuda:{torch.cuda.current_device()}",
                "traffic": dict(mesh.traffic),
                "state_dict": {k: v.cpu() for k, v in model.state_dict().items()} if rank == 0 else None}


def dryrun_multichip(n: int, device=None) -> list:
    """Run the dry run on ``n`` ranks and return each rank's result: its loss,
    mesh and coordinate, the layers split over ``model``, the serving outputs
    gathered over ``data`` (boxes, scores, masks, accumulator of all ``V``
    videos), its ``proto_decode`` launches, backend and device; rank 0's also
    the weights after the step.  The backend is ``nccl`` where each rank has a
    card of its own, else ``gloo`` (several ranks on one card, or the CPU); the
    ranks have ``RANK_TIMEOUT_S`` seconds."""
    from yolo_puncture_tpu_torch.parallel.mesh import spawn_ranks
    from yolo_puncture_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= n else "gloo"
    results = spawn_ranks(_rank, n, (dev.type, backend), timeout=RANK_TIMEOUT_S,
                          threads=1 if dev.type == "cpu" else None)
    r0 = results[0]
    print(f"dryrun_multichip(n={n}): mesh={r0['mesh']} loss={r0['loss']:.3f} serve_out={tuple(r0['boxes'].shape)} "
          f"videos={r0['acc'].shape[0]} backend={r0['backend']} OK", flush=True)
    return results
