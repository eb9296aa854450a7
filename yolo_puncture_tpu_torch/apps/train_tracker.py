"""Train the temporal-propagation network on synthetic motion clips: the port's
``apps/train_tracker.py``.

    python -m yolo_puncture_tpu_torch.apps.train_tracker --steps 2000 --clips mixed

The JAX app's flags and printed lines (``propagation IoU before: …``, the
trainer's ``propagation step i: loss …``, ``propagation IoU after: …``,
``saved …``).  The rollout runs the tracker's kernels and their gradients
(``track/train.py``).  The output is a flax msgpack checkpoint
(``utils/convert.py export_tracker_msgpack``) that ``TrackerCore(variables=path)``
of either package loads; ``--init`` and ``--backbone_init`` read flax msgpack
files.  ``main(argv, device=None)`` runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--clip_len", type=int, default=4)
    parser.add_argument("--max_objects", type=int, default=4)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--output", default="resources/weights/tracker_propagation.msgpack")
    parser.add_argument("--init", default=None, help="msgpack weights to resume from")
    parser.add_argument("--eval_clips", type=int, default=16)
    parser.add_argument(
        "--shared", action="store_true",
        help="train the shared-backbone path: PyramidAdapter + decoder against a "
        "frozen YOLO backbone pyramid (the fused-pipeline configuration)",
    )
    parser.add_argument("--detector_scale", default="s", help="frozen YOLO backbone scale for --shared (n/s/m/l/x)")
    parser.add_argument(
        "--backbone_init", default=None,
        help="flax msgpack of TRAINED detector variables for the frozen --shared backbone; a random "
        "backbone's features do not generalize — scale must match --detector_scale",
    )
    parser.add_argument(
        "--window_mix", type=float, default=0.0,
        help="fraction of steps trained through the WINDOWED propagation program (exposure "
        "consistency for the batched serving path); requires (clip_len-1) %% window == 0",
    )
    parser.add_argument("--window", type=int, default=4)
    parser.add_argument(
        "--clips", default="mixed", choices=["bars", "mixed", "needle"],
        help="training clip distribution: 'bars' = axis-aligned moving bars; 'mixed' = "
        "domain-randomized (textured backgrounds, rotated shrinking needle-like objects); "
        "'needle' = serving-aligned thin-shaft puncture clips (70%%) + domain-randomized (30%%)",
    )
    return parser.parse_args(argv)


def build_trainer(args, device=None):
    """(TrackerCore, PropagationTrainer) as the JAX app builds them: a ring of 4
    written every frame, long-term memory off."""
    from yolo_puncture_tpu_torch.models.yolo import pyramid_channels_for
    from yolo_puncture_tpu_torch.track import TrackerCore
    from yolo_puncture_tpu_torch.track import train as tt

    pyr_channels = pyramid_channels_for("v10", args.detector_scale) if args.shared else (128, 256, 512)
    core = TrackerCore(
        image_size=(args.height, args.width),
        max_objects=args.max_objects,
        mem_frames=4,
        mem_every=1,
        enable_long_term=False,
        pyramid_adapter=args.shared,
        pyramid_channels=pyr_channels,
        variables=args.init if args.init and os.path.exists(args.init) else None,
        device=device,
    )
    pyramid_fn = None
    if args.shared:
        from yolo_puncture_tpu_torch.utils.convert import read_msgpack

        bvars = read_msgpack(args.backbone_init) if args.backbone_init else None
        pyramid_fn, _ = tt.make_yolo_pyramid_fn(scale=args.detector_scale, seed=0, variables=bvars,
                                                device=core.device)
    clip_fn = {"bars": None, "mixed": tt.make_domain_randomized_clip,
               "needle": tt.make_needle_serving_clip}[args.clips]
    trainer = tt.PropagationTrainer(
        core, lr=args.lr, clip_len=args.clip_len, batch_size=args.batch,
        pyramid_fn=pyramid_fn, clip_fn=clip_fn,
        window_mix=args.window_mix, window=args.window,
    )
    return core, trainer


def main(argv=None, device=None):
    from yolo_puncture_tpu_torch.utils.convert import export_tracker_msgpack

    args = parse_args(argv)
    core, trainer = build_trainer(args, device)
    iou0 = trainer.eval_propagation_iou(args.eval_clips)
    print(f"propagation IoU before: {iou0:.3f}")
    trainer.fit(steps=args.steps, log_every=max(args.steps // 20, 1))
    iou1 = trainer.eval_propagation_iou(args.eval_clips)
    print(f"propagation IoU after: {iou1:.3f}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    export_tracker_msgpack(core.net, args.output)
    print(f"saved {args.output}")
    return iou0, iou1


if __name__ == "__main__":
    main()
