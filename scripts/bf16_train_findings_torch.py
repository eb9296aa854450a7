#!/usr/bin/env python3
"""Three CPU measurements behind the bf16 training notes (PERF.md §6, ROADMAP Queue 3).

    JAX_PLATFORMS=cpu python3 scripts/bf16_train_findings_torch.py

1. The bf16 tracker's serving outputs against the JAX package's bf16 tracker
   (the needle checkpoint, 64×112, a detection, three steps and a window of 8;
   ``affinity_bf16`` on and off), with the network's BatchNorm statistics and
   affine parameters fp32 (``to_compute_dtype``, as now) and rounded to bf16
   (``.to(bfloat16)``, as ``TrackerCore`` cast them before): mean and largest
   absolute probability difference, and the share of equal ids.
2. The JAX package's detection losses of YOLOv10-n seg at 64² in fp32 and bf16
   on ``tests/test_torch_train_detector.py``'s batch: the assigner is discrete.
3. The operations (``torch.profiler``, all levels) of one backward of
   ``DecodeTail`` at the trainer's shape (3 frames × 4 objects, 16² → 64²) in
   fp32, and in bf16 with the kernels packed by ``subpix_up_weights`` under
   autograd (before) and by ``packed_kernel`` (now).

Imports the JAX package as the reference, as the CPU tests do; minutes on a CPU.
"""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def tracker_statistics() -> None:
    from tests.test_torch_bench import FRAME_HW, _frames, _needle
    from yolo_puncture_tpu.track import ObjectInfo as JaxObjectInfo
    from yolo_puncture_tpu.track.core import TrackerCore as JaxTrackerCore
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore

    frames = _frames(12)[..., ::-1].copy()
    mask = np.zeros(FRAME_HW, np.int32)
    mask[30:44, 20:80] = 1
    for aff in (True, False):
        kw = dict(image_size=(64, 112), max_objects=2, mem_frames=4, mem_every=4, enable_long_term=False,
                  affinity_bf16=aff)
        cores = {"JAX": (JaxTrackerCore(variables=_needle(), dtype=jnp.bfloat16, **kw), JaxObjectInfo),
                 "fp32 statistics": (TrackerCore(variables=_needle(), dtype=torch.bfloat16, device="cpu", **kw),
                                     ObjectInfo),
                 "bf16 statistics": (TrackerCore(variables=_needle(), dtype=torch.bfloat16, device="cpu", **kw),
                                     ObjectInfo)}
        cores["bf16 statistics"][0].net.to(torch.bfloat16)
        out = {}
        for name, (core, info) in cores.items():
            probs = [core.incorporate_detection(frames[0], mask, [info(id=1)])]
            probs += [core.step(f) for f in frames[1:4]]
            probs += list(core.step_batch(list(frames[4:12])))
            out[name] = np.stack([np.asarray(p) for p in probs])
        for name in ("fp32 statistics", "bf16 statistics"):
            d = np.abs(out[name] - out["JAX"])
            same = (out[name].argmax(1) == out["JAX"].argmax(1)).mean()
            print(f"tracker affinity_bf16={aff}, {name}: probabilities against JAX bf16 mean {d.mean():.4g}, "
                  f"largest {d.max():.4g}; ids equal {same:.5f}")


def detector_losses() -> None:
    from tests.test_torch_train_detector import _batch, _variables
    from yolo_puncture_tpu.models.yolo import YOLOModel
    from yolo_puncture_tpu.train.losses import detection_loss

    variables, batch = _variables("v10"), _batch()
    for dt in (jnp.float32, jnp.bfloat16):
        model = YOLOModel(version="v10", scale="n", nc=1, task="segment", dtype=dt)

        def losses(v, b):
            out, _ = model.apply(v, b["images"], train=True, mutable=["batch_stats"])
            return detection_loss(out, b, nc=1)[1]

        got = jax.jit(losses)(variables, jax.tree.map(jnp.asarray, batch))
        print(f"JAX YOLOv10-n seg 64^2 losses in {jnp.dtype(dt).name}: "
              + ", ".join(f"{k} {float(v):.4f}" for k, v in got.items()))


def tail_operations() -> None:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from yolo_puncture_tpu_torch.nn.common import to_compute_dtype
    from yolo_puncture_tpu_torch.ops.kernels import decode_tail as dt

    net = cs.needle_network("cpu")

    def count(dtype):
        hidden, f8p, f4p = (t.to(dtype) for t in cs.tail_inputs(3, 4, 16, 16, torch.float32, 601, "cpu"))
        hidden.requires_grad_()
        dec = to_compute_dtype(copy.deepcopy(net.decoder).requires_grad_(True), dtype)
        out = dt.decode_tail(dec.tail_params(dtype), hidden, f8p, f4p)
        out.backward(torch.ones_like(out), retain_graph=True)              # warm-up
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out.backward(torch.ones_like(out), retain_graph=True)
        return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))

    now = dt.packed_kernel
    print(f"DecodeTail backward operations: fp32 {count(torch.float32)}, bf16 {count(torch.bfloat16)}")
    dt.packed_kernel = lambda w: dt.subpix_up_weights(w.permute(2, 3, 1, 0))
    try:
        print(f"DecodeTail bf16 backward operations with subpix_up_weights under autograd: {count(torch.bfloat16)}")
    finally:
        dt.packed_kernel = now


def main() -> int:
    torch.set_num_threads(4)
    tracker_statistics()
    detector_losses()
    tail_operations()
    return 0


if __name__ == "__main__":
    sys.exit(main())
