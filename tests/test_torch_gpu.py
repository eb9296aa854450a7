"""The port on the card: each CUDA kernel against its plain PyTorch version, and
``YOLO.predict``, ``TrackerCore`` and the speed pipeline's device step on ``cuda``
against the same code on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch (the repository's ``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

# torch_parity is imported by its own name (pytest puts tests/ on sys.path): a machine
# may have another distribution's top-level ``tests`` package installed, which would
# shadow ``tests.torch_parity``.  chip_smoke.py lies at the repository's root, where
# ``python -m pytest`` is run from; it holds every kernel's cases, inputs and limits.
from chip_smoke import (
    NEEDLE,
    PROTO_CASES,
    READOUT_AFFINITY_CASES,
    READOUT_CASES,
    READOUT_FP64_CASES,
    TAIL_CASES,
    BarDetector,
    bar_frames,
    check_decode_tail_case,
    check_proto_decode_case,
    check_pipeline_step,
    check_readout_affinity_case,
    check_readout_case,
    check_readout_fp64_case,
    needle_clip,
    pipeline_conf,
    pipeline_step_numpy,
    run_track_app,
)
from yolo_puncture_tpu_torch.ops.kernels.decode_tail import decode_tail
from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout
from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", PROTO_CASES, ids=lambda c: "-".join(map(str, c)))
def test_proto_decode_kernel_matches_plain_version(cuda, case):
    """The cases, the inputs and the limits are ``chip_smoke.py``'s: fp32 soft masks
    within 1e-6, binary masks equal outside 1e-6 around the threshold; bf16 (the
    ``proto_decode_bf16`` kernel: the bf16 detector's, pipeline's and bench's launches)
    within one bf16 ulp, binary masks equal except where the soft values differ;
    pixel counts that are no multiple of the kernel's 4-pixel vectors or of its
    blocks, 1 to 70 instances, box edges on vector boundaries, thresholds taken as a
    logit and as a sigmoid.  Each call of the wrapper counts one launch."""
    bf16 = len(case) > 7 and case[7] == torch.bfloat16
    calls = 2 if bf16 and case[4] is not None else 1   # a bf16 threshold case also decodes the soft masks
    before = (proto_decode.launches, proto_decode.launches_bf16)
    check_proto_decode_case(case, cuda, seed=7)
    assert (proto_decode.launches, proto_decode.launches_bf16) == (before[0] + calls * (not bf16),
                                                                   before[1] + calls * bf16)


@pytest.mark.gpu
def test_proto_decode_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(1, 32, 8, 8, device=cuda)
    c, b = torch.zeros(1, 2, 32, device=cuda), torch.zeros(1, 2, 4, device=cuda)
    with pytest.raises(TypeError):
        proto_decode(p.double(), c.double(), b.double())
    with pytest.raises(ValueError):
        proto_decode(p.transpose(2, 3), c, b)
    with pytest.raises(ValueError):
        proto_decode(torch.zeros(1, 16, 8, 8, device=cuda), torch.zeros(1, 2, 16, device=cuda), b)
    with pytest.raises(TypeError):                      # bf16 protos take bf16 coefficients: no fp32 copy
        proto_decode(p.bfloat16(), c, b)
    with pytest.raises(TypeError):                      # boxes stay fp32
        proto_decode(p.bfloat16(), c.bfloat16(), b.bfloat16())


@pytest.mark.gpu
def test_proto_decode_takes_a_view_that_is_not_16_byte_aligned(cuda):
    """Protos that start 4 bytes into an allocation go through the element-wise path."""
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.standard_normal(2 * 32 * 16 * 20 + 1).astype(np.float32)).to(cuda)
    p = flat[1:].view(2, 32, 16, 20)
    c = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32)).to(cuda)
    b = torch.tensor([[[2.0, 1.0, 15.0, 12.0]] * 3] * 2, device=cuda)
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode_reference

    got = proto_decode(p, c, b)
    torch.cuda.synchronize()
    assert float((got - proto_decode_reference(p, c, b)).abs().max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("retina", [False, True])
def test_predict_on_the_card_matches_the_cpu(cuda, retina):
    from yolo_puncture_tpu_torch import YOLO

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (2, 96, 160, 3)).astype(np.uint8)
    frames[:, 20:60, 30:120] += 150
    kw = dict(conf=0.0, imgsz=64, retina_masks=retina)
    gpu_det = YOLO("yolo10n-seg", nc=1, max_det=20, max_masks=4, seed=1)
    before = proto_decode.launches
    got = gpu_det.predict(list(frames), **kw)
    assert proto_decode.launches > before
    ref = YOLO("yolo10n-seg", nc=1, max_det=20, max_masks=4, seed=1, device="cpu").predict(list(frames), **kw)
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        for i in range(len(g)):  # near-equal scores may come in another order: match by value
            j = int(np.argmin(np.abs(r.boxes.xyxy - g.boxes.xyxy[i]).max(1)
                              + 1e3 * np.abs(r.boxes.conf - g.boxes.conf[i])))
            assert g.boxes.cls[i] == r.boxes.cls[j]
            np.testing.assert_allclose(g.boxes.xyxy[i], r.boxes.xyxy[j], rtol=0, atol=1e-2)
            np.testing.assert_allclose(g.boxes.conf[i], r.boxes.conf[j], rtol=0, atol=1e-4)
            assert (g.masks.data[i] == r.masks.data[j]).mean() >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("case", READOUT_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_memory_readout_kernel_matches_plain_version(cuda, case, dtype, scale):
    """The cases, the inputs and the limits are ``chip_smoke.py``'s: fp32 within 2e-4
    (fp32 sums in another order), bf16 within ``readout_bf16_limit`` at every element,
    with a softmax spread over the memory (scale 1) and one carried by a few elements
    (scale 2)."""
    before = memory_readout.launches
    check_readout_case(case, dtype, scale, cuda, seed=3)
    assert memory_readout.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", READOUT_FP64_CASES, ids=lambda c: "-".join(map(str, c)))
def test_memory_readout_fp32_kernel_is_fp32_class_on_large_logits(cuda, case):
    """Against a float64 readout with logits of 30 and more: a kernel that dropped the
    low parts of its TF32 split (one TF32 product) would be a hundred times off."""
    before = memory_readout.launches
    check_readout_fp64_case(case, cuda)
    assert memory_readout.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", READOUT_AFFINITY_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_memory_readout_kernel_with_bf16_affinity_matches_plain_version(cuda, case, dtype, scale):
    """``affinity_bf16=True`` (each logit rounded to bf16, as the bench's tracker
    reads memory): ``chip_smoke.py``'s cases and ``readout_affinity_limit``, and the
    kernel nearer the rounded plain version than the unrounded one."""
    before = memory_readout.launches
    check_readout_affinity_case(case, dtype, scale, cuda, seed=5)
    assert memory_readout.launches == before + 1


@pytest.mark.gpu
def test_memory_readout_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = torch.zeros(4, 64, device=cuda), torch.zeros(6, 64, device=cuda), torch.zeros(2, 6, 128, device=cuda)
    ok = torch.ones(6, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        memory_readout(q.double(), k.double(), v.double(), ok)
    with pytest.raises(TypeError):
        memory_readout(q.bfloat16(), k, v, ok)
    with pytest.raises(ValueError):
        memory_readout(q, k, torch.zeros(2, 6, 64, device=cuda), ok)
    with pytest.raises(ValueError):
        memory_readout(q, k, v.transpose(0, 1).contiguous().transpose(0, 1), ok)
    with pytest.raises(ValueError):
        memory_readout(torch.zeros(4, 32, device=cuda), torch.zeros(6, 32, device=cuda), v, ok)
    with pytest.raises(ValueError):                           # a view that is not 16-byte aligned
        memory_readout(torch.zeros(4 * 64 + 1, device=cuda)[1:].view(4, 64), k, v, ok)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TAIL_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tail_kernel_matches_plain_version(cuda, case, dtype):
    """``chip_smoke.py``'s cases and limits (fp32 2e-4, bf16 5e-2) on a seeded decoder
    with non-trivial BatchNorm statistics: the window, one frame, and shapes that leave
    the kernel's 32 x 8 pixel tiles ragged in both stages, down to a single pixel."""
    from yolo_puncture_tpu_torch.track.network import MaskDecoder

    torch.manual_seed(0)
    dec = MaskDecoder().to(cuda).eval()
    with torch.no_grad():
        for bn in (dec.dec8.bn, dec.dec4.bn):
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.normal_(1, 0.1)
            bn.bias.normal_(0, 0.1)
    before = decode_tail.launches
    check_decode_tail_case(dec.tail_params(dtype), case, cuda, seed=4)
    assert decode_tail.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("long_term", [False, True])
def test_tracker_on_the_card_matches_the_cpu(cuda, long_term):
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (9, 64, 96, 3)).astype(np.uint8)
    for i in range(9):
        frames[i, 20:32, 10 + 2 * i:42 + 2 * i] = 230
    mask = np.zeros((64, 96), np.int32)
    mask[20:32, 10:42] = 1
    geo = dict(image_size=(64, 96), max_objects=3, mem_frames=2, mem_every=2, enable_long_term=long_term,
               num_prototypes=8, max_long_term_elements=32, seed=5)
    gpu, cpu = TrackerCore(**geo), TrackerCore(device="cpu", **geo)
    counts = (memory_readout.launches, decode_tail.launches)
    out = {}
    for core in (gpu, cpu):
        probs = [core.incorporate_detection(frames[0], mask, [ObjectInfo(id=1)])]
        probs += [core.step(f) for f in frames[1:4]]
        out[core] = np.stack(probs + list(core.step_batch(list(frames[4:9]))))
    assert decode_tail.launches > counts[1]
    assert (memory_readout.launches > counts[0]) == (not long_term)   # the usage-bearing readout is plain PyTorch
    np.testing.assert_allclose(out[gpu], out[cpu], rtol=0, atol=1e-3)
    assert gpu.memory.write_pos == cpu.memory.write_pos and gpu.memory.frame_idx == cpu.memory.frame_idx
    assert gpu.memory.valid.tolist() == cpu.memory.valid.tolist()


@pytest.mark.gpu
def test_pipeline_step_on_the_card_matches_the_cpu(cuda):
    """One batch of ``VideoSpeedPipeline._step`` (letterbox, YOLOv10n seg, the best
    slot's mask through ``proto_decode``, crops, EfficientNet-B0) on the card and
    on the CPU, same seeded weights: ``chip_smoke.py``'s phase 4 limits."""
    from yolo_puncture_tpu_torch import YOLO
    from yolo_puncture_tpu_torch.pipeline import VideoSpeedPipeline
    from yolo_puncture_tpu_torch.tasks import ClassifierNet

    frames, _, _ = needle_clip(8, 96, 160, 4, seed=0)

    def make(device):
        return VideoSpeedPipeline(YOLO("yolo10n-seg", nc=1, seed=1, device=device),
                                  ClassifierNet("efficientnet_b0", input_size=64, seed=1, device=device),
                                  device_batch=8, imgsz=64, crop_size=64)

    gpu, cpu = make(None), make("cpu")
    conf, _ = pipeline_conf(cpu, frames)
    before = proto_decode.launches
    got = pipeline_step_numpy(gpu, frames, conf)
    assert proto_decode.launches == before + 1
    check_pipeline_step(got, pipeline_step_numpy(cpu, frames, conf))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [
    ["--temporal_setting", "online", "--disable_long_term"],
    ["--align_voting", "propagate"],
    ["--batch_propagation", "--align_voting", "affinity", "--disable_long_term"],
], ids=["online", "propagate", "batched-affinity"])
def test_track_video_on_the_card_matches_the_cpu(cuda, tmp_path, mode):
    """``chip_smoke.py``'s track_video phase at a small depth: 8 frames of 720p with
    the bar detector, the tracker at 128×224 with the needle checkpoint, on the card
    and on the CPU: the same segments in ``pred.json`` (areas within 1 %), id maps
    ≥ 99.9 % equal, the tail kernel launched, the readout kernel where long-term
    memory is off; then the seeded YOLOv10n at imgsz 64 as the detector launches
    ``proto_decode``."""
    from yolo_puncture_tpu_torch.ops.kernels.proto_decode import proto_decode

    frames, _ = bar_frames(8, 720, 1280, seed=4)
    argv = ["--video_name", "bar", "--img_path", "decoded-frames", "--model", str(tmp_path / "yolo10n-seg"),
            "--size", "120", "--imgsz", "64", "--tracker_weights", NEEDLE, "--num_voting_frames", "2",
            "--detection_every", "3"] + mode
    counts = (memory_readout.launches, decode_tail.launches)
    gpu = run_track_app(argv + ["--output", str(tmp_path / "gpu")], frames, BarDetector())
    assert decode_tail.launches > counts[1]
    assert (memory_readout.launches > counts[0]) == ("--disable_long_term" in mode)
    cpu = run_track_app(argv + ["--output", str(tmp_path / "cpu")], frames, BarDetector(), device="cpu")
    for g, c in zip(gpu["pred"]["annotations"], cpu["pred"]["annotations"]):
        assert [s["id"] for s in g["segments_info"]] == [s["id"] for s in c["segments_info"]] == [1]
        for gs, cs in zip(g["segments_info"], c["segments_info"]):
            assert abs(gs["area"] - cs["area"]) <= 0.01 * cs["area"]
    for g, c in zip(gpu["ids"], cpu["ids"]):
        assert (g == c).mean() >= 0.999
    before = proto_decode.launches
    run_track_app(argv + ["--output", str(tmp_path / "yolo")], frames)
    assert proto_decode.launches > before
