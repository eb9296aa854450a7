"""The ``yolo``-style CLI: the port's ``apps/yolo_cli.py``.

    python -m yolo_puncture_tpu_torch.apps.yolo_cli train data=datasets/needle model=yolo10s-seg epochs=100 imgsz=640
    python -m yolo_puncture_tpu_torch.apps.yolo_cli val   data=datasets/needle model=runs/train
    python -m yolo_puncture_tpu_torch.apps.yolo_cli predict model=yolo10s-seg source=img.png conf=0.35

The JAX CLI's ``key=value`` arguments and printed lines.  ``train``
(``data``, ``model``, ``epochs``, ``imgsz``, ``batch``, ``nc``, ``project``,
the augmentation keys, ``augment``, ``lr0``, ``clip``, ``close_mosaic``,
``ckpt_every``, ``resume``) fine-tunes with ``train/trainer.py Trainer`` on one
card, from the weights ``YOLO(model)`` loads (a seeded init for a bare name),
and writes ``{project}/step_N.pt``; it prints the trainer's ``epoch … step …``
lines and ``training done: …``.  ``val`` (``data``, ``model``, ``imgsz``,
``conf``, ``nc``, ``arch``, ``use_ema``) reads a port checkpoint (a
``step_N.pt`` file or a directory of them, built as ``arch``) or anything
``YOLO`` reads (a flax msgpack, an ultralytics ``.pt``, a name), predicts the
val split with retina masks and prints the box and mask mAP lines.
``predict`` (``model``, ``nc``, ``source``, ``conf``, ``imgsz``,
``retina_masks``) prints per result ``{path}: {n} instances``, then
``  cls=… conf=… xyxy=[…]`` per box; a source of PNG files is read without cv2.
``calibrate`` and ``export`` raise ``NotImplementedError`` until the tenth
slice of the port.  ``main(argv, device=None)`` runs on the card unless
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


def cmd_train(kv, device=None):
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
        clip_norm=float(kv.get("clip", 0.0)),
    )
    state = trainer.fit(
        ds, epochs=epochs, batch_size=batch, ckpt_dir=ckpt,
        close_mosaic=int(kv.get("close_mosaic", 10)),
        ckpt_every=int(kv.get("ckpt_every", 1000)),
        resume=kv.get("resume"),
    )
    print(f"training done: {int(state.step)} steps; checkpoints in {ckpt}")
    return state


def _is_checkpoint(path: str) -> bool:
    return os.path.isdir(path) or bool(re.fullmatch(r"step_\d+\.pt", os.path.basename(path)))


def cmd_val(kv, device=None):
    import numpy as np
    import torch

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
        from yolo_puncture_tpu_torch.train import Trainer

        det = YOLO(kv.get("arch", "yolo10s-seg"), nc=nc, device=device)
        restored = Trainer.load_checkpoint(model_path)
        use_ema = kv.get("use_ema", "false").lower() == "true"
        params = (restored.get("ema_params") if use_ema else None) or restored["params"]
        with torch.no_grad():
            for tree in (params, restored.get("batch_stats", {})):
                det.model.load_state_dict(tree, strict=False)
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


def _later(cmd):
    def run(kv, device=None):
        raise NotImplementedError(f"yolo_cli {cmd} is not ported yet (ROADMAP Queue 1, slice 10)")

    return run


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    cmd, kv = argv[0], parse_kv(argv[1:])
    commands = {"predict": cmd_predict, "train": cmd_train, "val": cmd_val,
                **{c: _later(c) for c in ("calibrate", "export")}}
    return commands[cmd](kv, device=device)


if __name__ == "__main__":
    main()
