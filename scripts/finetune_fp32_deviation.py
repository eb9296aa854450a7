#!/usr/bin/env python3
"""How far fp32 gradients of the fine-tuners are from float64, on the CPU.

    python3 scripts/finetune_fp32_deviation.py [--unet-size 320] [--unet-batch 4]
                                               [--van-size 380] [--van-batch 16]

One ``UNetFinetuner`` step of the seeded U2NETP on ``chip_smoke.bar_masks``
(the batch of ``chip_smoke.py`` phase 3t), then one ``ClassifierFinetuner`` step
of the seeded VAN-B0 on ``chip_smoke.brightness_crops`` (the first batch of
phase 3z (e)), each in fp32 and in float64 from the same weights; prints the
loss's relative difference, the largest difference of a tensor's gradient
relative to its norm (over tensors whose gradient is at least 1e-3 of the
whole) and, for the others (biases before a train-mode BatchNorm, whose
gradient is rounding), the largest difference relative to the whole gradient's
norm.  ``chip_smoke.py`` takes ten times these as its limits for the card
against the CPU (``FT_LIMITS``).
"""

import argparse
import copy
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def deviation(what: str, l32: float, l64: float, m32, m64) -> None:
    """Print the loss's and the gradients' fp32 deviation from float64 after one step of each."""
    total = float(torch.sqrt(sum((p.grad ** 2).sum() for p in m64.parameters())))
    live, vanishing = [(0.0, "")], [(0.0, "")]
    for (name, a), b in zip(m32.named_parameters(), m64.parameters()):
        err, norm = float((a.grad.double() - b.grad).norm()), float(b.grad.norm())
        if norm >= 1e-3 * total:
            live.append((err / norm, name))
        else:                       # a bias before a train-mode BatchNorm: its gradient is rounding
            vanishing.append((err / total, name))
    print(f"{what}: loss {l32:.9f} fp32, {l64:.9f} float64, relative {abs(l32 - l64) / abs(l64):.3g}")
    print(f"largest gradient difference of a tensor whose gradient is at least 1e-3 of the whole, relative to "
          f"its norm: {max(live)[0]:.4g} ({max(live)[1]})")
    print(f"largest gradient difference of the others, relative to the whole gradient: {max(vanishing)[0]:.4g} "
          f"({max(vanishing)[1]})", flush=True)


def main(argv=None) -> int:
    import chip_smoke as cs
    from yolo_puncture_tpu_torch.tasks import ClassifierNet, UNetPredictor
    from yolo_puncture_tpu_torch.train import ClassifierFinetuner, UNetFinetuner

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unet-size", type=int, default=320)
    ap.add_argument("--unet-batch", type=int, default=4)
    ap.add_argument("--van-size", type=int, default=380)
    ap.add_argument("--van-batch", type=int, default=16)
    args = ap.parse_args(argv)
    cpu = torch.device("cpu")

    images, masks = cs.bar_masks(4 * args.unet_batch, args.unet_size, seed=31)
    x, m = torch.from_numpy(images[:args.unet_batch]), torch.from_numpy(masks[:args.unet_batch])
    p32 = UNetPredictor("u2netp", seed=0, device="cpu")
    m64 = copy.deepcopy(p32.model).double()
    f32 = UNetFinetuner(p32)
    f64 = UNetFinetuner(types.SimpleNamespace(model=m64, device=cpu))
    l32, l64 = float(f32.step(x, m)), float(f64.step(x.double(), m.double()))
    deviation(f"U2NETP {args.unet_size}^2, batch {args.unet_batch}", l32, l64, p32.model, m64)

    crops, labels = cs.brightness_crops(4 * args.van_batch, args.van_size, seed=41)
    x, y = torch.from_numpy(crops[:args.van_batch]), torch.from_numpy(labels[:args.van_batch])
    n32 = ClassifierNet("van_b0", input_size=args.van_size, seed=0, device="cpu")
    m64 = copy.deepcopy(n32.model).double()
    m64.dtype = torch.float64
    f32 = ClassifierFinetuner(n32, lr=5e-4, seed=0)
    f64 = ClassifierFinetuner(types.SimpleNamespace(model=m64, device=cpu, input_size=args.van_size), lr=5e-4, seed=0)
    l32, l64 = float(f32.step(x, y)[0]), float(f64.step(x, y)[0])
    deviation(f"VAN-B0 {args.van_size}^2, batch {args.van_batch}", l32, l64, n32.model, m64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
