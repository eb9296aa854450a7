"""The port's training entry points on the CPU against the JAX package's apps.

``apps/train_tracker.py`` and the port's ``apps/train_tracker.py`` train the
same seeded tracker (``--init``, a flax msgpack) on the same clips for two Adam
steps and print the same lines; each package loads the other's output.
``yolo_cli train`` runs two steps on a synthetic PNG dataset and writes a
checkpoint that ``yolo_cli val`` reads; ``val`` of a flax msgpack prints the
JAX CLI's lines for the same weights.

Limits.  The IoU lines equal (inference of the same weights on the same clips);
the losses within 2e-4 (printed to 4 decimals; the values agree within 1e-6);
the trained weights: each parameter's move ‖Δp_port − Δp_jax‖ ≤ 1e-3 · ‖Δp_jax‖
+ lr · 1e-2 · √n.  Adam divides each gradient by its own running magnitude, so
an element whose gradient is rounding noise (the key projection's, nearly
cancelled between the query and key paths, 1e-5 of the whole gradient) moves by
a step of order lr whose size and sign follow that noise; the √n term allows a
hundredth of such steps over the tensor's n elements.
"""

import re

import numpy as np
import pytest

from tests.torch_parity import seeded_tracker_variables, write_seg_dataset
from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)

TRACKER_ARGS = ["--steps", "2", "--height", "32", "--width", "48", "--clip_len", "4", "--max_objects", "2",
                "--batch", "2", "--eval_clips", "2", "--lr", "2e-4"]


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_train_tracker_prints_the_jax_apps_lines_and_the_checkpoints_cross_load(tmp_path, capsys):
    import jax
    from flax import serialization

    from apps import train_tracker as jax_app
    from yolo_puncture_tpu.track.core import TrackerCore as JaxCore
    from yolo_puncture_tpu_torch.apps import train_tracker
    from yolo_puncture_tpu_torch.track import TrackerCore
    from yolo_puncture_tpu_torch.utils.convert import export_tracker_state_dict, read_msgpack, write_msgpack

    init = str(tmp_path / "init.msgpack")
    write_msgpack(seeded_tracker_variables(seed=8, image_hw=(32, 48)), init)
    out_j, out_p = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jax_app.main(TRACKER_ARGS + ["--init", init, "--output", out_j])
    ref = _lines(capsys.readouterr().out)
    train_tracker.main(TRACKER_ARGS + ["--init", init, "--output", out_p], device="cpu")
    got = _lines(capsys.readouterr().out)

    assert len(got) == len(ref) == 5
    assert got[0] == ref[0] and got[0].startswith("propagation IoU before: ")
    for g, r in zip(got[1:3], ref[1:3]):
        assert g.split(": loss ")[0] == r.split(": loss ")[0]
        assert abs(float(g.split(": loss ")[1]) - float(r.split(": loss ")[1])) <= 2e-4
    assert got[3] == ref[3] and got[3].startswith("propagation IoU after: ")
    assert got[4] == f"saved {out_p}" and ref[4] == f"saved {out_j}"

    # the trained weights: two Adam steps from the same init
    start = export_tracker_state_dict(read_msgpack(init))
    mine, theirs = export_tracker_state_dict(read_msgpack(out_p)), export_tracker_state_dict(read_msgpack(out_j))
    moved = 0
    for name, p0 in start.items():
        d_got, d_ref = mine[name] - p0, theirs[name] - p0
        if name.endswith(("running_mean", "running_var")):
            assert not d_got.any() and not d_ref.any(), name     # statistics stay frozen
            continue
        moved += int(np.abs(d_ref).max() > 0)
        limit = 1e-3 * np.linalg.norm(d_ref) + 2e-4 * 1e-2 * np.sqrt(d_ref.size)
        assert np.linalg.norm(d_got - d_ref) <= limit, (name, np.linalg.norm(d_got - d_ref), limit)
    assert moved > 50

    # each package reads the other's file
    template = JaxCore(image_size=(32, 48), max_objects=2, mem_frames=4, mem_every=1, enable_long_term=False).variables
    with open(out_p, "rb") as f:
        restored = serialization.from_bytes(template, f.read())
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(read_msgpack(out_p))):
        assert np.array_equal(np.asarray(a), b)
    with open(out_j, "rb") as f:
        assert write_msgpack(read_msgpack(out_j)) == f.read()               # the JAX file, byte for byte
    core = TrackerCore(variables=out_j, image_size=(32, 48), max_objects=2, device="cpu")
    frame = np.full((32, 48, 3), 90, np.uint8)
    frame[8:20, 10:30] = 230
    mask = np.zeros((32, 48), np.int32)
    mask[8:20, 10:30] = 1
    from yolo_puncture_tpu_torch.track import ObjectInfo

    core.incorporate_detection(frame, mask, [ObjectInfo(id=1)])
    assert np.isfinite(core.step(frame)).all()


def test_train_tracker_options(tmp_path, capsys):
    from yolo_puncture_tpu_torch.apps import train_tracker

    args = train_tracker.parse_args(["--clips", "needle", "--window_mix", "0.5", "--window", "3"])
    core, trainer = train_tracker.build_trainer(args, device="cpu")
    assert (core.mem_every, core.enable_long_term, core.image_size, core.max_objects) == (1, False, (256, 256), 4)
    assert trainer.clip_fn.__name__ == "make_needle_serving_clip" and trainer.window_loss_fn is not None
    out = str(tmp_path / "t.msgpack")
    train_tracker.main(["--steps", "1", "--height", "32", "--width", "32", "--clip_len", "4", "--max_objects", "2",
                        "--batch", "1", "--eval_clips", "1", "--clips", "bars", "--window_mix", "1.0",
                        "--window", "3", "--output", out], device="cpu")
    lines = _lines(capsys.readouterr().out)
    assert re.fullmatch(r"propagation step 0: loss \d+\.\d{4}", lines[1]) and lines[-1] == f"saved {out}"


def test_yolo_cli_train_then_val(tmp_path, capsys):
    """``train`` for two steps (batch 2 of four images, augmented), its
    checkpoint read by ``val``; the lines of the JAX CLI's format strings."""
    from yolo_puncture_tpu_torch.apps import yolo_cli

    root = write_seg_dataset(tmp_path / "data", n_train=4)
    run = tmp_path / "run"
    state = yolo_cli.main(["train", f"data={root}", "model=yolov8n-seg", "epochs=1", "imgsz=64", "batch=2",
                           f"project={run}", "ckpt_every=1", "clip=10"], device="cpu")
    assert state.step == 2 and sorted(p.name for p in run.iterdir()) == ["step_1.pt", "step_2.pt"]
    assert _lines(capsys.readouterr().out) == [f"training done: 2 steps; checkpoints in {run}"]
    yolo_cli.main(["val", f"data={root}", f"model={run}", "arch=yolov8n-seg", "imgsz=64"], device="cpu")
    lines = _lines(capsys.readouterr().out)
    assert re.fullmatch(r"box  mAP50=\d\.\d{3} mAP50-95=\d\.\d{3}", lines[0])
    assert len(lines) == 1 or re.fullmatch(r"mask mAP50=\d\.\d{3} mAP50-95=\d\.\d{3}", lines[1])
    yolo_cli.main(["val", f"data={root}", f"model={run}/step_1.pt", "arch=yolov8n-seg", "imgsz=64",
                   "use_ema=true"], device="cpu")
    assert _lines(capsys.readouterr().out)[0].startswith("box  mAP50=")


def test_yolo_cli_val_of_a_flax_checkpoint_prints_what_the_jax_cli_prints(tmp_path, capsys):
    import cv2

    from apps import yolo_cli as jax_cli
    from tests.torch_parity import seeded_detector_variables
    from yolo_puncture_tpu_torch.apps import yolo_cli
    from yolo_puncture_tpu_torch.utils.convert import write_msgpack

    root = write_seg_dataset(tmp_path / "data", n_train=1, n_val=3, seed=4)
    frames = np.stack([cv2.resize(cv2.imread(str(p)), (64, 64))
                       for p in sorted((root / "images" / "val").iterdir())])
    weights = str(tmp_path / "yolov8n-seg.msgpack")
    write_msgpack(seeded_detector_variables("v8", frames, 64, seed=6), weights)
    argv = ["val", f"data={root}", f"model={weights}", "imgsz=64", "conf=0.001"]
    jax_cli.main(argv)
    ref = _lines(capsys.readouterr().out)
    yolo_cli.main(argv, device="cpu")
    assert _lines(capsys.readouterr().out) == ref and ref[0].startswith("box  mAP50=")


@pytest.mark.parametrize("cmd", ["calibrate", "export"])
def test_later_commands_raise(cmd, tmp_path):
    """Both commands are ported; what they cannot do raises: ``calibrate`` of a
    model that is not a checkpoint, ``export`` to a format of the JAX CLI."""
    from yolo_puncture_tpu_torch.apps import yolo_cli

    if cmd == "calibrate":
        with pytest.raises(FileNotFoundError):
            yolo_cli.main([cmd, f"model={tmp_path / 'step_1.pt'}", "arch=yolov8n-seg"], device="cpu")
    else:
        with pytest.raises(SystemExit, match="JAX package's CLI"):
            yolo_cli.main([cmd, "model=yolov8n-seg", "format=stablehlo"], device="cpu")
