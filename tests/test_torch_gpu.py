"""The port on the card: each CUDA kernel against its plain PyTorch version, and
``YOLO.predict``, ``TrackerCore`` and the speed pipeline's device step on ``cuda``
against the same code on the CPU; the backward of the tracker's two kernels
(``MemoryReadout``, ``DecodeTail``) against their CPU path and float64; the
fine-tuners, ``yolo_cli calibrate`` / ``export`` and the bench's other modes
(``chip_smoke.py`` phases 3t–3w at reduced sizes); the int8 convolution, int8
``predict`` and the int8-ring tracker against their CPU runs (phase 3y (a), (b),
(d) at reduced sizes); VAN and SAM (phase 3z at reduced sizes); data and tensor
parallelism (phase 3zb at a reduced size).

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
    INT8_SCALE_REL,
    NEEDLE,
    PROTO_CASES,
    READOUT_AFFINITY_CASES,
    READOUT_CASES,
    READOUT_FP64_CASES,
    READOUT_GRAD_CASES,
    TAIL_CASES,
    TAIL_GRAD_CASES,
    BarDetector,
    bar_frames,
    bench_modes_phase,
    calibrate_phase,
    check_decode_tail_case,
    check_int8_conv,
    check_int8_distance,
    check_int8_heads,
    check_int8_layers,
    check_proto_decode_case,
    check_pipeline_step,
    check_readout_affinity_case,
    check_readout_case,
    check_readout_fp64_case,
    check_readout_bf16_grad_case,
    check_readout_grad_case,
    check_tail_bf16_grad_case,
    check_tail_grad_case,
    dp_phase,
    export_phase,
    finetune_phase,
    int8_distance,
    int8_heads,
    needle_clip,
    needle_network,
    pipeline_conf,
    pipeline_step_numpy,
    run_track_app,
    train_apps_phase,
    write_mp4,
    zoo_phase,
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", READOUT_GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_memory_readout_backward_matches_the_cpu_and_float64(cuda, case):
    """``chip_smoke.py``'s cases (the tracker trainer's readout, full and half
    filled, and the app's frame) and ``readout_grad_limits``: the kernel's forward,
    the Function's backward, against the same Function on the CPU and a float64
    autograd readout on the card."""
    before = memory_readout.launches
    check_readout_grad_case(case, cuda, seed=7)
    assert memory_readout.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", READOUT_GRAD_CASES[:2] + TAIL_GRAD_CASES[:2], ids=lambda c: "-".join(map(str, c)))
def test_bf16_backward_of_both_kernels_matches_float64(cuda, case):
    """bf16 training: ``MemoryReadout``'s and ``DecodeTail``'s bf16 backward at
    the tracker trainer's shapes within ``chip_smoke.BF16_GRAD_ROUNDINGS`` · 2^-8
    of float64 gradients of the same bf16 values, and away from the fp32
    Function's; the forward is the kernel's bf16 route."""
    counter = memory_readout if len(case) == 4 and isinstance(case[3], str) else decode_tail
    before = counter.launches
    if counter is memory_readout:
        check_readout_bf16_grad_case(case, cuda, seed=9)
    else:
        check_tail_bf16_grad_case(needle_network(cuda), case, cuda, seed=10)
    assert counter.launches > before


@pytest.mark.gpu
@pytest.mark.parametrize("case", TAIL_GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decode_tail_backward_matches_the_cpu_and_float64(cuda, case):
    """The tail's gradients (activations and the eight raw weights) with the
    needle checkpoint's decoder, within ``tail_grad_limit_rel`` of the CPU's and
    of a float64 run of the un-packed tail."""
    before = decode_tail.launches
    check_tail_grad_case(needle_network(cuda), case, cuda, seed=8)
    assert decode_tail.launches == before + 1


@pytest.mark.gpu
def test_kernels_keep_the_autograd_graph_on_cuda(cuda):
    """A CUDA input that requires a gradient never comes back without a
    ``grad_fn``, in fp32 and in bf16 (bf16 training); fp16 raises."""
    q, k, v = (torch.randn(*s, device=cuda) for s in ((64, 64), (300, 64), (2, 300, 128)))
    ok = torch.ones(300, dtype=torch.bool, device=cuda)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        assert memory_readout(*args, ok).grad_fn is not None
    assert memory_readout(q.bfloat16().requires_grad_(), k.bfloat16(), v.bfloat16(), ok).grad_fn is not None
    with pytest.raises(TypeError):
        memory_readout(q.half().requires_grad_(), k.half(), v.half(), ok)
    net = needle_network(cuda)
    h = torch.randn(1, 2, 4, 4, 128, device=cuda)
    f8, f4 = torch.randn(1, 8, 8, 64, device=cuda), torch.randn(1, 16, 16, 64, device=cuda)
    params = net.decoder.tail_params(torch.float32)
    assert decode_tail(params, h.requires_grad_(), f8, f4).grad_fn is not None
    net.decoder.out.weight.requires_grad_(True)
    assert decode_tail(net.decoder.tail_params(torch.float32), h.detach(), f8, f4).grad_fn is not None
    h16 = h.detach().bfloat16().requires_grad_()
    assert decode_tail(net.decoder.tail_params(torch.bfloat16), h16, f8.bfloat16(), f4.bfloat16()).grad_fn is not None


@pytest.mark.gpu
def test_finetuners_on_the_card_match_the_cpu(cuda):
    """3t at reduced sizes (B3 at 96², batch 4; U2NETP at 64², batch 2): one step
    against the CPU, 20 steps whose loss falls, ``fit_arrays``' statistics against
    float64."""
    out = finetune_phase("gpu test", device=cuda, cls_size=96, cls_batch=4, unet_size=64, unet_batch=2)
    assert out["classifier"]["ms_per_step"] > 0 and out["unet"]["peak_gib"] > 0


@pytest.mark.gpu
def test_calibrate_and_export_on_the_card(cuda, tmp_path):
    """3s-3v at reduced sizes: ``yolo_cli train`` (YOLOv8-n at 128²) and its
    checkpoint through ``calibrate`` on the card against the CPU (``proto_decode``
    launched), then ``export`` of YOLOv10-S at 128², the serving graph reloaded
    without the port."""
    train_apps_phase(str(tmp_path), imgsz=128, device=cuda, model="yolov8n-seg",
                     tracker_argv=["--height", "64", "--width", "64", "--batch", "2"])
    assert calibrate_phase(str(tmp_path), "gpu test", imgsz=128, model="yolov8n-seg", device=cuda) > 0
    assert export_phase(str(tmp_path), "gpu test", imgsz=128, batch=2, device=cuda)["torch_export"] > 0


@pytest.mark.gpu
def test_bench_modes_on_the_card(cuda):
    """3w at B 8: ``--mode e2e`` (``proto_decode_bf16`` once a batch, the same output
    as ``process_frames``), ``--mode e2e_device``, ``--unfused`` (both tracker
    kernels) and ``--long-term`` (no readout kernel)."""
    got = bench_modes_phase("gpu test", 640, batch=8, iters=2, e2e_batch=8, e2e_iters=2, e2e_device_iters=2,
                            device=cuda)
    assert got["proto_decode_bf16"] > 0 and got["memory_readout_bf16"] > 0 and got["decode_tail_bf16"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 16, 64, 64, 32, 3, 2), (1, 3, 96, 96, 16, 3, 2), (3, 24, 20, 20, 40, 1, 1)],
                         ids=lambda c: "-".join(map(str, c)))
def test_int8_conv_on_the_card_matches_the_cpu(cuda, case):
    """3y (a) at small shapes (a 3×3 stride-2, the first layer's K = 27, a 1×1):
    the int8 operands equal the CPU's, the int32 product equals a float64
    convolution of them, the output within ``INT8_OUT_REL`` of the CPU's."""
    out = check_int8_conv(cuda, case=case)
    assert out["max_rel_err"] <= 1e-6 and out["ms"]["int8"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_predict_on_the_card_matches_the_cpu(cuda, dtype):
    """3y (b) at small size (YOLOv10n at 128², two frames): ``predict`` with
    dynamic scales, then after ``calibrate_int8`` (its scales within
    ``INT8_SCALE_REL`` of the CPU's, the card's run on both sides); every int8
    convolution on its card input against the CPU's (``check_int8_layers``); the
    head over every anchor (``check_int8_heads``) and the detections
    (``check_int8_distance``) against the CPU within ``INT8_DIRECT`` times the
    CPU's int8-versus-fp gap (the detections: or the fp tolerances)."""
    from yolo_puncture_tpu_torch import YOLO

    frames, _, _ = needle_clip(2, 96, 160, 1, seed=3)
    kw = dict(conf=0.0, imgsz=128)
    fp = YOLO("yolo10n-seg", nc=1, seed=2, dtype=dtype, max_det=20, device=cuda)
    q8 = YOLO("yolo10n-seg", nc=1, seed=2, dtype=dtype, max_det=20, int8_serving=True, device=cuda)
    cpu = YOLO("yolo10n-seg", nc=1, seed=2, dtype=dtype, max_det=20, int8_serving=True, device="cpu")
    ref = fp.predict(list(frames), **kw)
    for calibrate in (False, True):
        if calibrate:
            scales, cpu_scales = q8.calibrate_int8(list(frames), imgsz=128), cpu.calibrate_int8(list(frames), imgsz=128)
            assert set(scales) == set(cpu_scales)
            assert max(abs(scales[k] - cpu_scales[k]) / cpu_scales[k] for k in scales) <= INT8_SCALE_REL[dtype]
            cpu._act_scales = dict(scales)
        before = proto_decode.launches_bf16 if dtype == torch.bfloat16 else proto_decode.launches
        got = q8.predict(list(frames), **kw)
        after = proto_decode.launches_bf16 if dtype == torch.bfloat16 else proto_decode.launches
        assert after > before and len(got) == len(ref) == 2
        assert check_int8_layers(q8, cpu, frames, 128)["convolutions"] == 72
        check_int8_heads("int8 head on the card", int8_heads(q8, frames, 128), int8_heads(cpu, frames, 128),
                         int8_heads(fp, frames, 128))
        cpu_got = cpu.predict(list(frames), **kw)
        check_int8_distance("int8 predict on the card", int8_distance(got, cpu_got), int8_distance(cpu_got, ref))


@pytest.mark.gpu
def test_int8_ring_tracker_on_the_card_matches_the_cpu(cuda):
    """3y (d) at small size: the int8-ring tracker (64×96, the needle checkpoint)
    over a detection, three steps and a window on the card and on the CPU:
    probabilities within 1e-3, the readout kernel never launched, the tail
    launched."""
    from yolo_puncture_tpu_torch.track import ObjectInfo, TrackerCore

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (9, 64, 96, 3)).astype(np.uint8)
    for i in range(9):
        frames[i, 20:32, 10 + 2 * i:42 + 2 * i] = 230
    mask = np.zeros((64, 96), np.int32)
    mask[20:32, 10:42] = 1
    geo = dict(image_size=(64, 96), max_objects=3, mem_frames=4, mem_every=2, enable_long_term=False,
               quantized_memory=True, variables=NEEDLE)
    gpu, cpu = TrackerCore(**geo), TrackerCore(device="cpu", **geo)
    counts = (memory_readout.launches, decode_tail.launches)
    out = {}
    for core in (gpu, cpu):
        probs = [core.incorporate_detection(frames[0], mask, [ObjectInfo(id=1)])]
        probs += [core.step(f) for f in frames[1:4]]
        out[core] = np.stack(probs + list(core.step_batch(list(frames[4:9]))))
    assert memory_readout.launches == counts[0] and decode_tail.launches > counts[1]
    np.testing.assert_allclose(out[gpu], out[cpu], rtol=0, atol=1e-3)
    assert gpu.memory.keys.dtype == torch.int8 and gpu.memory.write_pos == cpu.memory.write_pos


@pytest.mark.gpu
def test_van_and_sam_on_the_card_match_the_cpu(cuda, tmp_path):
    """3z at reduced sizes: VAN-B0 at 96² (B 4) against the CPU, fp32 and bf16, every
    variant's parameter count, b2's forward, the pipeline with VAN-B0 (``proto_decode``
    once a batch), ``evaluate_speed --cls_model van_b0 --cls_init`` where cv2 can
    write the mp4, the fine-tuner; SAM ``vit_b`` at 256² against the CPU and its
    generator twice on a 180×320 frame."""
    import importlib.util

    clip = needle_clip(24, 180, 320, key_frame=8, seed=2)[0]
    mp4 = decoded = None
    if importlib.util.find_spec("cv2") is not None:
        mp4 = str(tmp_path / "needle.mp4")
        decoded = write_mp4(mp4, list(clip))
    got = zoo_phase("gpu test", clip, decoded, mp4, imgsz=128, device=cuda, van_size=96, van_batch=4, ft_steps=12,
                    deep=("van_b2",), sam_size=256, sam_frame_hw=(180, 320), sam_types=("vit_b",),
                    points_per_side=8, sam_batch=16)
    assert got["proto_decode"] > 0 and got["proto_decode_bf16"] > 0



@pytest.mark.gpu
def test_data_parallel_phase_on_the_card(cuda):
    """3zb at 128²: ``Trainer(mesh=)`` on one NCCL rank and on four gloo ranks on the
    card (4×1, 2×2) against the single-process step, every rank's state equal, and
    ``dryrun_multichip(4)`` with ``proto_decode`` launched on every rank."""
    got = dp_phase("gpu test", imgsz=128, device=cuda, steps=1)
    assert got["proto_decode"] >= 8
