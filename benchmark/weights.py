"""Seeded weights of a configuration, made on the device by the benchmark itself.

The repository has no trained detector, so every cell runs random weights drawn
from ``--seed``: a LeCun-normal draw for every convolution kernel, from one
``torch.randn`` call on the device per network, rounded to the type the program
serves in (so the program and the reference hold the same values); zero
biases and the YOLO head's bias init.

The detector's BatchNorm statistics are measured by the reference in one
train-mode forward of seeded images with fine and coarse content (white noise,
smooth fields, sharp blocks), as the repository's seeded detector measures
them, and its BatchNorm scale is 0.25 (``BN_GAIN``), which keeps each SiLU near
its linear part.  How far one grey level on a third of the pixels moves the
fp32 network measures how chaotic a draw is: with statistics measured on the
cell's own low-contrast frames, bf16 rounding moved boxes by hundreds of
pixels; at scale 1 the grey level moved YOLOv10-X's best boxes, at 640², by a
median of 165–219 px on the card; at 0.5 some draws of YOLOv10-S moved their
scores by 0.048 at the 75th percentile (640², on the CPU); at 0.25 every draw
tried stayed within 2e-4.

The one-to-one class bias is then moved so that the median best score over 16
of the cell's frames is ``score_target``: with the ultralytics init no score
would pass the confidence threshold.  The mask coefficients' last convolution
is scaled so that the best anchor's mask logits spread by ``MASK_LOGIT_STD``:
left as drawn, they lie within a few hundredths of 0, every pixel's sigmoid sits
at the 0.5 threshold, and bf16's rounding of it (to 0.5 itself, below the
threshold) halves every mask.  The tracker keeps its BatchNorm at identity, as
the repository's seeded tracker does; its mask head is centred and scaled the
same way (``tracker``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark import reckon
from benchmark.reference import tracker as rt
from benchmark.reference.tracker import TrackerNet
from benchmark.reference.yolo import YOLOv10Seg, letterbox

CALIB_SIZE = 256   # the side of the BatchNorm calibration images
BN_GAIN = 0.25     # the detector's BatchNorm scale: each block's output at a quarter of its normalised size
MASK_LOGIT_STD = 4.0   # the spread of the mask logits: the best anchor's over the prototype grid, the tracker's


def _draw_kernels(model: nn.Module, gen: torch.Generator, dtype: torch.dtype) -> None:
    convs = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    total = sum(m.weight.numel() for m in convs)
    draw = torch.randn(total, generator=gen, device=gen.device)
    at = 0
    with torch.no_grad():
        for m in convs:
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            w.copy_((draw[at:at + w.numel()].view_as(w) * math.sqrt(1.0 / fan_in)).to(dtype).float())
            at += w.numel()
            if m.bias is not None:
                m.bias.zero_()


def _seeded_generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))


def _round_to(model: nn.Module, served: torch.dtype) -> nn.Module:
    """Every parameter outside BatchNorm rounded to the served type, kept fp32:
    the values the program holds."""
    for m in model.modules():
        if not isinstance(m, nn.BatchNorm2d):
            for p in m.parameters(recurse=False):
                p.data.copy_(p.data.to(served).float())
    return model


@torch.no_grad()
def detector(cfg: Dict, seed: int, frames_u8: torch.Tensor, device, served: torch.dtype) -> YOLOv10Seg:
    """The reference detector of ``cfg['detector']`` with the seed's weights, on
    ``device``, in eval mode; ``frames_u8`` (16 of the cell's frames) set the
    class bias and the mask coefficients' scale."""
    d = cfg["detector"]
    with torch.device(device):
        model = YOLOv10Seg(d["scale"], d["nc"], d["nm"], d["npr"])
    _draw_kernels(model, _seeded_generator(seed, 1, device), served)
    head = model.model[-1]
    for box, cls in ((head.cv2, head.cv3), (head.one2one_cv2, head.one2one_cv3)):
        for i, s in enumerate(head.strides):
            box[i][-1].bias.fill_(1.0)
            cls[i][-1].bias.fill_(math.log(5 / head.nc / (640 / s) ** 2))
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            m.weight.fill_(BN_GAIN)
            m.momentum = 1.0                 # the running statistics become the batch's
    g = _seeded_generator(seed, 3, device)
    n = CALIB_SIZE
    images = torch.cat([
        torch.rand((2, 3, n, n), generator=g, device=device),
        F.interpolate(torch.rand((2, 3, 8, 8), generator=g, device=device), size=(n, n), mode="bilinear"),
        F.interpolate(torch.rand((2, 3, 8, 8), generator=g, device=device), size=(n, n), mode="nearest"),
    ])
    model.train()
    model(images)
    model.eval()
    _round_to(model, served)
    out = model(letterbox(frames_u8.to(device), d["imgsz"]))
    best = torch.logit(out["probs"].amax(dim=(1, 2)).double(), eps=1e-15).median()
    shift = math.log(d["score_target"] / (1 - d["score_target"])) - float(best)
    for cls in head.one2one_cv3:
        cls[-1].bias.add_(shift)
    top = out["probs"].amax(dim=2).argmax(dim=1)
    coeffs = out["coeffs"][torch.arange(len(top), device=top.device), top]
    logits = torch.einsum("bc,bchw->bhw", coeffs, out["proto"])
    gain = MASK_LOGIT_STD / float(logits.std())
    for cv in head.cv4:
        cv[-1].weight.mul_(gain)
        cv[-1].bias.mul_(gain)
    return _round_to(model, served)


@torch.no_grad()
def tracker(cfg: Dict, seed: int, frames_u8: torch.Tensor, device, served: torch.dtype) -> TrackerNet:
    """The reference tracker network with the seed's weights, BatchNorm at
    identity, its mask head set on ``frames_u8`` (two windows of the cell's
    frames, the second reading what the first wrote) so that the object logits
    have median 0 and spread ``MASK_LOGIT_STD``: as drawn, a positive mean of the
    decoder's features times the head's random weights puts nearly every pixel
    on one side, and the id maps would carry no edge to compare."""
    t = cfg["tracker"]
    with torch.device(device):
        net = TrackerNet()
    _draw_kernels(net, _seeded_generator(seed, 2, device), served)
    _round_to(net, served).eval()
    hw = reckon.tracker_hw(cfg)
    trk = rt.Tracker(net, hw, t["window"], False)
    st = rt.initial_state(hw[0] // 16, hw[1] // 16, t["max_objects"], t["mem_frames"], 8, device)
    n = 2 * t["window"]
    _, hidden, f4, f8 = trk.propagate(st, frames_u8[:n].to(device))
    dec = net.decoder
    logits = torch.stack([dec.tail(hidden[i], dec.skip8(f8[i:i + 1])[0], dec.skip4(f4[i:i + 1])[0])[0]
                          for i in range(t["window"], n)])
    gain = MASK_LOGIT_STD / float(logits.std())
    dec.out.bias.copy_((dec.out.bias - logits.median()) * gain)
    dec.out.weight.mul_(gain)
    return _round_to(net, served)


def served_state(model: nn.Module, served: torch.dtype) -> Dict[str, torch.Tensor]:
    """The state dict handed to the program: BatchNorm tensors in fp32, every
    other parameter in the served type (its values are already rounded to it)."""
    bn_prefixes = {name + "." for name, m in model.named_modules() if isinstance(m, nn.BatchNorm2d)}
    return {k: v if any(k.startswith(p) for p in bn_prefixes) or not v.is_floating_point() else v.to(served)
            for k, v in model.state_dict().items()}
