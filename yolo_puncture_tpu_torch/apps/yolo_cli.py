"""The ``yolo``-style CLI: the port's ``apps/yolo_cli.py``.

    python -m yolo_puncture_tpu_torch.apps.yolo_cli predict model=yolo10s-seg source=img.png conf=0.35

``predict`` takes the JAX CLI's ``key=value`` arguments (``model``, ``nc``,
``source``, ``conf``, ``imgsz``, ``retina_masks``) and prints its lines: per
result ``{path}: {n} instances``, then ``  cls=… conf=… xyxy=[…]`` per box.
A source of PNG files is read without cv2.  ``train``, ``val``, ``calibrate``
and ``export`` belong to the port of training (ROADMAP item 11) and raise
``NotImplementedError`` until then.  ``main(argv, device=None)`` runs on the
card unless ``device="cpu"``.
"""

from __future__ import annotations

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


def _training(cmd):
    def run(kv, device=None):
        raise NotImplementedError(f"yolo_cli {cmd} is part of training, not ported yet (ROADMAP item 11)")

    return run


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    cmd, kv = argv[0], parse_kv(argv[1:])
    commands = {"predict": cmd_predict, **{c: _training(c) for c in ("train", "val", "calibrate", "export")}}
    return commands[cmd](kv, device=device)


if __name__ == "__main__":
    main()
