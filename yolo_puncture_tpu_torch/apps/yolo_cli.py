"""The ``yolo``-style CLI: the port's ``apps/yolo_cli.py``.

    python -m yolo_puncture_tpu_torch.apps.yolo_cli train data=datasets/needle model=yolo10s-seg epochs=100 imgsz=640
    python -m yolo_puncture_tpu_torch.apps.yolo_cli val   data=datasets/needle model=runs/train
    python -m yolo_puncture_tpu_torch.apps.yolo_cli calibrate data=datasets/needle model=runs/train/step_N.pt
    python -m yolo_puncture_tpu_torch.apps.yolo_cli predict model=yolo10s-seg source=img.png conf=0.35
    python -m yolo_puncture_tpu_torch.apps.yolo_cli export model=yolo10s-seg format=msgpack

The JAX CLI's ``key=value`` arguments and printed lines.  ``train``
(``data``, ``model``, ``epochs``, ``imgsz``, ``batch``, ``nc``, ``project``,
the augmentation keys, ``augment``, ``lr0``, ``clip``, ``close_mosaic``,
``ckpt_every``, ``resume``) fine-tunes with ``train/trainer.py Trainer`` from the
weights ``YOLO(model)`` loads (a seeded init for a bare name), data-parallel
over the largest number of visible cards that divides ``batch`` (one process a
card, NCCL; as the JAX CLI takes the devices), and writes
``{project}/step_N.pt``; it prints the trainer's ``epoch … step …`` lines and
``training done: …`` (the first rank alone).  ``val`` (``data``, ``model``, ``imgsz``,
``conf``, ``nc``, ``arch``, ``use_ema``) reads a port checkpoint (a
``step_N.pt`` file or a directory of them, built as ``arch``) or anything
``YOLO`` reads (a flax msgpack, an ultralytics ``.pt``, a name), predicts the
val split with retina masks and prints the box and mask mAP lines.
``calibrate`` (``data``, ``model``: a checkpoint, ``arch``, ``imgsz``, ``nc``,
``use_ema``, default true, ``min_conf``) fits Platt scaling to the val split's
detections and writes ``calibration.json`` where ``YOLO.load_calibration``
reads it: into ``model`` when it is a directory, else beside the file.  A
checkpoint loads strictly in both: a key it lacks or one the model lacks raises.
``predict`` (``model``, ``nc``, ``source``, ``conf``, ``imgsz``,
``retina_masks``) prints per result ``{path}: {n} instances``, then
``  cls=… conf=… xyxy=[…]`` per box; a source of PNG files is read without cv2.
``export`` (``model``, ``nc``, ``format``, ``output``, ``imgsz``, ``batch``)
writes ``msgpack`` (the JAX package's flax variables: its ``YOLO`` loads the
file), ``torch`` (a pickle of the ultralytics-keyed state dict) or
``torch_export`` (``torch.export`` of the serving function, letterbox → model →
selection, at ``(batch, imgsz, imgsz, 3)`` uint8: it reloads with
``torch.export.load`` without this package; YOLOv10 only, since the v8/v11 NMS
sweeps on the host).  ``orbax``, ``stablehlo``, ``saved_model`` and ``tflite``
are the JAX CLI's.  ``main(argv, device=None)`` runs on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import os
import re
import sys


def parse_kv(args):
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got '{a}'")
        k, v = a.split("=", 1)
        out[k] = v
    return out


def cmd_predict(kv, device=None):
    from yolo_puncture_tpu_torch import YOLO

    det = YOLO(kv.get("model", "yolo10s-seg"), nc=int(kv.get("nc", 1)), device=device)
    results = det.predict(
        source=kv["source"],
        conf=float(kv.get("conf", 0.25)),
        imgsz=int(kv.get("imgsz", 640)),
        retina_masks=kv.get("retina_masks", "true").lower() == "true",
    )
    for r in results:
        print(f"{r.path or '<array>'}: {len(r.boxes)} instances")
        for i in range(len(r.boxes)):
            print(f"  cls={int(r.boxes.cls[i])} conf={r.boxes.conf[i]:.3f} "
                  f"xyxy={r.boxes.xyxy[i].round(1).tolist()}")
    return results


def data_parallel_size(batch: int, n_devices: int) -> int:
    """The JAX CLI's rule: the largest device count that divides the batch."""
    return max(d for d in range(1, n_devices + 1) if batch % d == 0)


def cmd_train(kv, device=None):
    """Data-parallel over the largest number of visible cards that divides
    ``batch``: with more than one, ``dp`` ranks (spawned, one card each, NCCL)
    each run ``train_rank``, and this returns None; else one process trains here
    and this returns the state."""
    import torch

    from yolo_puncture_tpu_torch.parallel.mesh import spawn_ranks
    from yolo_puncture_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    dp = data_parallel_size(int(kv.get("batch", 16)), n_dev)
    if dp > 1:
        spawn_ranks(train_rank, dp, (kv, "nccl", "cuda"), timeout=None)
        return None
    return _train(kv, dev, None)


def train_rank(rank: int, world_size: int, init_method: str, kv, backend: str, device_type: str):
    """The body of one rank of a data-parallel ``train``: its card (or the CPU),
    the process group on ``backend``, a ``(world_size, 1)`` mesh, then the run;
    the first rank prints and writes the checkpoints.  Returns the step reached."""
    import torch

    from yolo_puncture_tpu_torch.parallel.mesh import make_mesh, process_group

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    with process_group(rank, world_size, init_method, backend, device):
        return int(_train(kv, device, make_mesh((world_size, 1), devices=device_type)).step)


def _train(kv, device, mesh):
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.train import Trainer
    from yolo_puncture_tpu_torch.train.data import SegDataset

    data = kv.get("data", "datasets/needle")
    model_name = kv.get("model", "yolo10s-seg")
    epochs = int(kv.get("epochs", 100))
    imgsz = int(kv.get("imgsz", 640))
    batch = int(kv.get("batch", 16))
    nc = int(kv.get("nc", 1))
    ckpt = kv.get("project", "runs/train")

    model = YOLO(model_name, nc=nc, device=device).model
    aug = {k: float(kv[k]) for k in ("mosaic", "scale", "translate", "fliplr", "hsv_h", "hsv_s", "hsv_v") if k in kv}
    ds = SegDataset(data, split="train", imgsz=imgsz, augment=kv.get("augment", "true").lower() != "false", **aug)
    steps_per_epoch = max(1, len(ds) // batch)
    trainer = Trainer(
        model, nc=nc, imgsz=imgsz,
        lr0=float(kv.get("lr0", 0.01)),
        total_steps=epochs * steps_per_epoch,
        warmup_steps=min(3 * steps_per_epoch, 1000),
        mesh=mesh,
        clip_norm=float(kv.get("clip", 0.0)),
    )
    state = trainer.fit(
        ds, epochs=epochs, batch_size=batch, ckpt_dir=ckpt,
        close_mosaic=int(kv.get("close_mosaic", 10)),
        ckpt_every=int(kv.get("ckpt_every", 1000)),
        resume=kv.get("resume"),
    )
    if trainer.is_writer:
        print(f"training done: {int(state.step)} steps; checkpoints in {ckpt}")
    return state


def _is_checkpoint(path: str) -> bool:
    return os.path.isdir(path) or bool(re.fullmatch(r"step_\d+\.pt", os.path.basename(path)))


def _load_checkpoint(det, model_path: str, use_ema: bool) -> None:
    """Load a ``train`` checkpoint (a ``step_N.pt`` file or the newest of a
    directory) into ``det.model``: the EMA weights with ``use_ema`` where the
    checkpoint has them, else the trained parameters, and the BatchNorm
    statistics.  Every parameter and statistic of the model must be in the
    checkpoint and every tensor of the checkpoint in the model, or this raises."""
    from yolo_puncture_tpu_torch.train import Trainer
    from yolo_puncture_tpu_torch.utils.convert import load_yolo_state_dict

    restored = Trainer.load_checkpoint(model_path)
    params = (restored.get("ema_params") if use_ema else None) or restored["params"]
    load_yolo_state_dict(det.model, {**params, **restored.get("batch_stats", {})})


def cmd_val(kv, device=None):
    import numpy as np

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.ops.resize import resize_nearest
    from yolo_puncture_tpu_torch.train.data import SegDataset
    from yolo_puncture_tpu_torch.train.metrics import compute_map

    data = kv.get("data", "datasets/needle")
    model_path = kv.get("model", "yolo10s-seg")
    imgsz = int(kv.get("imgsz", 640))
    conf = float(kv.get("conf", 0.001))
    nc = int(kv.get("nc", 1))

    if _is_checkpoint(model_path):
        # a checkpoint of ``train``: the architecture from arch=, the trained weights;
        # the EMA only with use_ema=true (on short runs it is still near the init)
        det = YOLO(kv.get("arch", "yolo10s-seg"), nc=nc, device=device)
        _load_checkpoint(det, model_path, kv.get("use_ema", "false").lower() == "true")
    else:
        det = YOLO(model_path, nc=nc, device=device)
    ds = SegDataset(data, split="val", imgsz=imgsz, augment=False)
    preds, gts = [], []
    for i in range(len(ds)):
        item = ds.load(i)
        img_u8 = (item["images"][..., ::-1] * 255).astype(np.uint8)  # back to BGR
        r = det.predict(source=img_u8, conf=conf, imgsz=imgsz, retina_masks=True)[0]
        pred = {"boxes": r.boxes.xyxy, "scores": r.boxes.conf, "classes": r.boxes.cls}
        if r.masks is not None:
            pred["masks"] = r.masks.data
        preds.append(pred)
        m = item["mask_gt"]
        gt = {"boxes": item["gt_bboxes"][m], "classes": item["gt_labels"][m].astype(np.float32)}
        gt["masks"] = (np.stack([resize_nearest(g, (imgsz, imgsz)) for g in item["gt_masks"][m]])
                       if m.any() else np.zeros((0, imgsz, imgsz)))
        gts.append(gt)
    box_m = compute_map(preds, gts, use_masks=False)
    print(f"box  mAP50={box_m['map50']:.3f} mAP50-95={box_m['map50_95']:.3f}")
    if all("masks" in p for p in preds):
        mask_m = compute_map(preds, gts, use_masks=True)
        print(f"mask mAP50={mask_m['map50']:.3f} mAP50-95={mask_m['map50_95']:.3f}")
    return box_m


def _box_iou(b, g) -> float:
    ix = max(0.0, min(b[2], g[2]) - max(b[0], g[0]))
    iy = max(0.0, min(b[3], g[3]) - max(b[1], g[1]))
    inter = ix * iy
    ua = (b[2] - b[0]) * (b[3] - b[1]) + (g[2] - g[0]) * (g[3] - g[1]) - inter
    return inter / ua if ua > 0 else 0.0


def cmd_calibrate(kv, device=None):
    """Fit Platt confidence calibration on the val split and write
    ``calibration.json`` where ``YOLO.load_calibration`` reads it.

    The reported conf becomes about P(detection is a TP | raw score), so the
    apps' fixed operating points (conf 0.9 in the UI, 0.35 in the batch CLI) sit
    at sane raw thresholds for a checkpoint trained from scratch."""
    import json

    import numpy as np

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.train.data import SegDataset

    data = kv.get("data", "datasets/needle")
    model_path = kv["model"]
    imgsz = int(kv.get("imgsz", 640))
    nc = int(kv.get("nc", 1))
    det = YOLO(kv.get("arch", "yolo10s-seg"), nc=nc, device=device)
    _load_checkpoint(det, model_path, kv.get("use_ema", "true").lower() == "true")

    ds = SegDataset(data, split="val", imgsz=imgsz, augment=False)
    scores, labels, per_img = [], [], []
    for i in range(len(ds)):
        item = ds.load(i)
        img_u8 = (item["images"][..., ::-1] * 255).astype(np.uint8)
        r = det.predict(source=img_u8, conf=float(kv.get("min_conf", 0.001)), imgsz=imgsz, retina_masks=False)[0]
        gts = item["gt_bboxes"][item["mask_gt"]]
        conf = np.asarray(r.boxes.conf)
        xyxy = np.asarray(r.boxes.xyxy)
        taken = np.zeros(len(gts), bool)
        tp_flags = np.zeros(len(conf), bool)
        for j in np.argsort(-conf):          # greedy: each ground truth goes to its best remaining match
            best, bi = 0.0, -1
            for g in range(len(gts)):
                if not taken[g]:
                    v = _box_iou(xyxy[j], gts[g])
                    if v > best:
                        best, bi = v, g
            tp = best >= 0.5
            if tp:
                taken[bi] = True
                tp_flags[j] = True
            scores.append(float(conf[j]))
            labels.append(1.0 if tp else 0.0)
        per_img.append((conf, xyxy, tp_flags))

    def dup_rate(raw_thr):
        """The share of images with a duplicate: a false positive above the
        threshold overlapping (IoU > 0.5) a true positive above it."""
        n_dup = 0
        for conf, xyxy, tp_flags in per_img:
            keep = conf >= raw_thr
            tps = np.where(keep & tp_flags)[0]
            fps = np.where(keep & ~tp_flags)[0]
            if any(_box_iou(xyxy[f], xyxy[t]) > 0.5 for f in fps for t in tps):
                n_dup += 1
        return n_dup / max(len(per_img), 1)

    s = np.clip(np.asarray(scores), 1e-6, 1 - 1e-6)
    y = np.asarray(labels)
    x = np.log(s / (1 - s))
    # a 1-D logistic fit by Newton (Platt scaling), with Platt's prior-corrected targets for the tails
    n1, n0 = y.sum(), len(y) - y.sum()
    t = np.where(y > 0.5, (n1 + 1) / (n1 + 2), 1 / (n0 + 2))
    a, b = 1.0, 0.0
    for _ in range(50):
        p = 1 / (1 + np.exp(-(a * x + b)))
        g = np.array([((p - t) * x).sum(), (p - t).sum()])
        w = p * (1 - p)
        H = np.array([[(w * x * x).sum() + 1e-6, (w * x).sum()],
                      [(w * x).sum(), w.sum() + 1e-6]])
        da, db = np.linalg.solve(H, g)
        a, b = a - da, b - db
        if max(abs(da), abs(db)) < 1e-9:
            break
    a, b = float(a), float(b)

    raw_at = {u: round(det._calib_to_raw(u, (a, b)), 4) for u in (0.9, 0.5, 0.35, 0.25)}
    dups = {"raw0.25": round(dup_rate(0.25), 4),
            "raw0.5": round(dup_rate(0.5), 4),
            "cal0.9": round(dup_rate(raw_at[0.9]), 4),
            "cal0.35": round(dup_rate(raw_at[0.35]), 4)}
    out = {"a": a, "b": b, "n_det": len(scores), "n_images": len(ds),
           "n_tp": int(y.sum()), "raw_threshold_at_user_conf": raw_at,
           "duplicate_rate": dups}
    out_dir = model_path if os.path.isdir(model_path) else os.path.dirname(os.path.abspath(model_path))
    path = os.path.join(out_dir, "calibration.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"calibration a={a:.4f} b={b:.4f} over {len(scores)} detections "
          f"({int(y.sum())} TP) → {path}")
    print(f"raw thresholds at user conf: {raw_at}")
    print(f"duplicate rate: {dups}")
    return out


JAX_FORMATS = ("orbax", "stablehlo", "saved_model", "tflite")
FORMATS = ("msgpack", "torch", "torch_export")


def serving_module(det, imgsz: int):
    """The JAX CLI's serving function as a module: BGR uint8 frames (B, imgsz,
    imgsz, 3) → letterbox (BGR → RGB, in the model's dtype) → the model →
    ``select_detections(nms_free=v10, conf_thres=0.25, max_det)`` → (boxes,
    scores, classes)."""
    import torch

    from yolo_puncture_tpu_torch.ops.letterbox import letterbox
    from yolo_puncture_tpu_torch.ops.nms import select_detections

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = det.model

        def forward(self, frames_u8):
            imgs, _, _ = letterbox(frames_u8, imgsz, bgr_to_rgb=True, dtype=self.model.dtype)
            d = select_detections(self.model(imgs), nms_free=det.version == "v10", conf_thres=0.25,
                                  max_det=det.max_det)
            return d["boxes"], d["scores"], d["classes"]

    return Serve().eval()


def cmd_export(kv, device=None):
    """Export the detector's weights (``msgpack``, ``torch``) or its serving
    graph with its weights (``torch_export``)."""
    fmt = kv.get("format", "msgpack")
    if fmt in JAX_FORMATS:
        raise SystemExit(f"format={fmt} is a JAX / TensorFlow format: export it with the JAX package's CLI "
                         f"(python apps/yolo_cli.py export format={fmt})")
    if fmt not in FORMATS:
        raise SystemExit(f"unknown format {fmt} ({'|'.join(FORMATS)}; {'|'.join(JAX_FORMATS)} in the JAX CLI)")
    import pickle

    import torch

    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.utils.convert import write_msgpack, yolo_variables

    det = YOLO(kv.get("model", "yolo10s-seg"), nc=int(kv.get("nc", 1)), device=device)
    out = kv.get("output", f"export_{os.path.basename(det.weights_path)}.{fmt}")
    if fmt == "msgpack":
        write_msgpack(yolo_variables(det.model.state_dict()), out)
    elif fmt == "torch":
        sd = {k: v.detach().cpu().numpy() for k, v in det.model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        with open(out, "wb") as f:
            pickle.dump(sd, f)
    else:
        if det.version != "v10":
            raise SystemExit("format=torch_export requires an NMS-free v10 model: the v8/v11 NMS sweeps its "
                             "candidates on the host (ops/nms.py _nms_single), which torch.export cannot trace; "
                             "use a yolo10* model or format=torch")
        imgsz, batch = int(kv.get("imgsz", 640)), int(kv.get("batch", 1))
        example = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.uint8, device=det.device)
        with torch.no_grad():
            exported = torch.export.export(serving_module(det, imgsz), (example,))
        torch.export.save(exported, out)
    print(f"exported to {out}")
    return out


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    cmd, kv = argv[0], parse_kv(argv[1:])
    commands = {"predict": cmd_predict, "train": cmd_train, "val": cmd_val, "calibrate": cmd_calibrate,
                "export": cmd_export}
    return commands[cmd](kv, device=device)


if __name__ == "__main__":
    main()
