"""The bench's pieces against the JAX package: ``ops/resize.py resize_bilinear``
against ``jax.image.resize``, ``track.build_bench_tracker`` (window 4 and
window 1) against the JAX ``build_bench_tracker``, and the fused seg+track step
of ``yolo_puncture_tpu_torch/bench.py`` at B 8 against ``bench.py``'s
``fused_step`` body, rebuilt here from the JAX modules (``bench.py`` itself
probes a device when it is run, so it is not imported).

Sizes are cut for the CPU: 96×160 frames, the tracker at
``reference_tracker_geometry((96, 160), 64)`` = 64×112, the detector YOLOv10n
at imgsz 64; the tracker's weights are the shipped needle checkpoint.

Tolerances: the bf16 resize bit for bit, its fp32 form within 2e-6 of the
values; fp32 trackers id maps ≥ 99.9 % equal and the ring's bookkeeping equal.
The bf16 tracker with ``affinity_bf16=True`` reads memory through the readout
kernel's plain version, which rounds the logits to bf16 as the JAX package
rounds its affinity (``track/core.py``): its id maps are held to
``BF16_ID_AGREE`` of the JAX ones and its probabilities to ``BF16_PROB_TOL``.
What is left between the two is XLA's bf16 arithmetic on the CPU, not the
affinity: the JAX bf16 tracker is 0.043 from the port's fp32 one, and with the
option on against off only 0.023 from itself.  The detector's outputs are handed over from the JAX side
(``tests/test_torch_bf16.py`` holds the bf16 networks themselves), so the
step's detector half is held exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import NEEDLE_CHECKPOINT, repo_path, seeded_detector_variables  # noqa: F401
from tests.torch_parity import torch_single_thread  # noqa: F401
from yolo_puncture_tpu import track as jtrack
from yolo_puncture_tpu.models.yolo import YOLOModel as JaxYOLOModel
from yolo_puncture_tpu.ops.letterbox import letterbox as jax_letterbox
from yolo_puncture_tpu.ops.letterbox import letterbox_params as jax_letterbox_params
from yolo_puncture_tpu.ops.masks import decode_masks as jax_decode_masks
from yolo_puncture_tpu.ops.nms import select_detections as jax_select_detections
from yolo_puncture_tpu.track.core import TrackerCore as JaxTrackerCore
from yolo_puncture_tpu.track.network import PropagationNetwork as JaxPropagationNetwork
from yolo_puncture_tpu_torch import bench
from yolo_puncture_tpu_torch.models.yolo import pyramid_channels_for
from yolo_puncture_tpu_torch.ops.masks import _first_axis
from yolo_puncture_tpu_torch.ops.resize import resize_bilinear
from yolo_puncture_tpu_torch.track import TrackerCore, build_bench_tracker, reference_tracker_geometry

FRAME_HW, MIN_SIDE, IMGSZ, B = (96, 160), 64, 64, 8
SHARED_N_CHECKPOINT = "resources/weights/tracker_shared_n_trained.msgpack"
ID_AGREE = 0.999
# measured 0.99977 and 0.0491 (the bf16 affinity tracker against JAX's)
BF16_ID_AGREE = 0.999
BF16_PROB_TOL = 0.06
# masks after the handed-over head: XLA fuses the JAX package's jitted bf16 decode
# chain and keeps fp32 between fused operations where the port rounds each one,
# so a few boundary pixels flip (tests/test_torch_bf16.py MASK_AGREE)
MASK_AGREE = 0.995


def _frames(n=B, seed=0):
    """BGR uint8 frames of a bright bar moving right over noise."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 70, (n, *FRAME_HW, 3)).astype(np.uint8)
    for i in range(n):
        f[i, 30:44, 20 + 3 * i:80 + 3 * i] = 225
    return f


def _needle():
    return repo_path(NEEDLE_CHECKPOINT)


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((2, 72, 128, 3), (48, 86)), ((2, 24, 40, 3), (64, 96)),
                                       ((3, 96, 160, 3), (64, 112))],
                         ids=["720p-like-shrink", "upscale", "bench-geometry"])
def test_resize_bilinear_matches_jax_image_resize(shape, out):
    """bf16 bit for bit (the weights rounded to bf16, each contraction rounded,
    in XLA's order); fp32 within 2e-6 relative to the 0..255 values."""
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    B_, _, _, C = shape
    for jdt, tdt, tol in ((jnp.bfloat16, torch.bfloat16, 0.0), (jnp.float32, torch.float32, 255 * 2e-6)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x).astype(jdt), (B_, *out, C), "bilinear").astype(jnp.float32))
        got = resize_bilinear(torch.from_numpy(x).to(tdt), out)
        assert got.dtype == tdt and tuple(got.shape) == (B_, *out, C)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("hw,out", [((720, 1280), (480, 864)), ((24, 40), (64, 96)), ((160, 160), (720, 1280)),
                                    ((16, 16), (96, 128)), ((96, 160), (64, 112)), ((160, 160), (640, 640))])
def test_contraction_order_is_xlas(hw, out):
    """``_first_axis`` picks the axis that ``jax.image.resize``'s einsum contracts
    first (the first dot of its jaxpr)."""
    h, w = hw
    H, W = out
    jaxpr = str(jax.make_jaxpr(lambda a: jax.image.resize(a, (1, H, W, 3), "bilinear"))(
        jax.ShapeDtypeStruct((1, h, w, 3), jnp.bfloat16)))
    first = jaxpr[jaxpr.index("dot_general"):].split("\n")[0]
    first_out = jaxpr[:jaxpr.index("dot_general")].rsplit("\n", 1)[-1]
    assert ("h" if f"[{H}," in first_out else "w") == _first_axis(h, w, H, W), (first_out, first)


# ---------------------------------------------------------------------------
# build_bench_tracker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [4, 1])
def test_build_bench_tracker_matches_jax(window, monkeypatch):
    """Two batches of 8 streamed through both helpers (fp32 tracker, bf16 resize):
    id maps at full resolution ≥ ID_AGREE equal, and the ring's bookkeeping equal."""
    monkeypatch.setattr(jtrack, "TrackerCore", functools.partial(JaxTrackerCore, variables=_needle()))
    jmem, jrun = jtrack.build_bench_tracker(frame_hw=FRAME_HW, min_side=MIN_SIDE, window=window, jit=True)
    pmem, prun = build_bench_tracker(frame_hw=FRAME_HW, min_side=MIN_SIDE, window=window, variables=_needle(),
                                     device="cpu")
    for seed in (0, 1):
        frames = _frames(seed=seed)
        jmem, jids = jrun(jmem, jnp.asarray(frames))
        pmem, pids = prun(pmem, torch.from_numpy(frames))
        jids = np.asarray(jids)
        assert pids.dtype == torch.uint8 and tuple(pids.shape) == jids.shape == (B, 64, 112)
        agree = float((pids.numpy() == jids).mean())
        assert agree >= ID_AGREE, agree
        assert pmem.frame_idx == int(jmem.frame_idx) and pmem.write_pos == int(jmem.write_pos)
        np.testing.assert_array_equal(pmem.valid.numpy(), np.asarray(jmem.valid))
    assert len(np.unique(pids.numpy())) == 2      # the active object is tracked somewhere


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _detector_variables():
    return seeded_detector_variables("v10", _frames(), IMGSZ)


def _jax_fused_step(model, core):
    """``bench.py``'s ``fused_step`` body (the default best-slot decode; the
    tracker's own encoder, or with ``core.pyramid_adapter`` the detector's
    pyramid over the letterbox content, ``BENCH_SHARED=1``)."""
    th, tw = core.image_size
    trk_vars = core.variables
    _r, (new_w, new_h), (left, top) = jax_letterbox_params(*FRAME_HW, IMGSZ)
    content_box = ((top / IMGSZ, (top + new_h) / IMGSZ), (left / IMGSZ, (left + new_w) / IMGSZ))

    @jax.jit
    def fused_step(variables, mem, frames_u8, conf, chk):
        imgs, r, pad = jax_letterbox(frames_u8, IMGSZ, dtype=jnp.bfloat16, bgr_to_rgb=True)
        out = model.apply(variables, imgs)
        det = jax_select_detections(out, nms_free=True, conf_thres=conf, max_det=8)
        masks = jax_decode_masks(out["proto"], det["coeffs"][:, :1], det["boxes"][:, :1], (IMGSZ, IMGSZ),
                                 upsample=True, threshold=0.5)
        if core.pyramid_adapter:
            pyr = out["pyramid"]
            keys, skips = core.encode_pyramid(trk_vars, pyr["P3"], pyr["P4"], pyr["P5"], content_box=content_box)
        else:
            n = frames_u8.shape[0]
            timgs = jax.image.resize(frames_u8.astype(jnp.bfloat16), (n, th, tw, 3), "bilinear") / 255.0
            keys, skips = core.net.apply(trk_vars, timgs, method=JaxPropagationNetwork.encode_key)
        mem, ids = core.propagate_frames(trk_vars, mem, keys, skips, window=4, exact=True, full_res_ids=True)
        boxes, scores, valid = det["boxes"][:, 0], det["scores"][:, 0], det["valid"][:, 0]
        mask = masks[:, 0].astype(jnp.uint8)
        chk = (chk + boxes.astype(jnp.float32).sum() + scores.astype(jnp.float32).sum() + valid.sum()
               + mask[:, ::37, ::37].astype(jnp.int32).sum() + ids[:, ::64, ::64].astype(jnp.int32).sum())
        return {"boxes": boxes, "scores": scores, "valid": valid, "mask": mask, "ids": ids, "chk": chk}, mem, imgs, out

    return fused_step


class _HandOver:
    """The port detector's stand-in: checks its bf16 input against the JAX
    side's and returns the JAX head's outputs."""

    dtype = torch.bfloat16

    def __init__(self, imgs, out):
        self.imgs, self.out, self.calls = imgs, out, 0

    def __call__(self, x):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(self.imgs[self.calls].astype(jnp.float32)))
        out = self.out[self.calls]
        self.calls += 1

        def to_torch(a):
            if isinstance(a, dict):
                return {k: to_torch(v) for k, v in a.items()}
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
                torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)

        return to_torch(out)


def _check_fused_step(shared: bool):
    """Two chained steps of B 8 through the port's ``bench.make_fused_step`` and
    ``bench.py``'s step body: the best slot's boxes, scores and valid flags
    exactly and its masks ≥ MASK_AGREE equal (the head's outputs, and for the
    shared tracker the pyramid, handed over), the bf16 tracker's id maps ≥
    BF16_ID_AGREE equal, the ring's bookkeeping equal."""
    weights = repo_path(SHARED_N_CHECKPOINT) if shared else _needle()
    pyramid_channels = pyramid_channels_for("v10", "n") if shared else None
    jcore = JaxTrackerCore(variables=weights, dtype=jnp.bfloat16, image_size=reference_tracker_geometry(
        FRAME_HW, MIN_SIDE), max_objects=2, mem_frames=8, mem_every=4, enable_long_term=False, affinity_bf16=True,
        pyramid_adapter=shared, pyramid_channels=pyramid_channels or (128, 256, 512))
    jmem = jcore.memory._replace(active=jcore.memory.active.at[0].set(True))
    # the tracker as bench_models builds it
    pmem, ptrack = build_bench_tracker(IMGSZ, dtype=torch.bfloat16, min_side=MIN_SIDE, window=4, frame_hw=FRAME_HW,
                                       variables=weights, device="cpu", max_objects=2, full_res_ids=True,
                                       affinity_bf16=True, pyramid_channels=pyramid_channels)
    variables = _detector_variables()
    jstep = _jax_fused_step(JaxYOLOModel(version="v10", scale="n", nc=1, task="segment", dtype=jnp.bfloat16), jcore)
    jchk, pchk, n_valid = jnp.float32(0), torch.zeros(()), 0
    for seed in (0, 1):
        frames = _frames(seed=seed)
        ref, jmem, imgs, head = jstep(variables, jmem, jnp.asarray(frames), jnp.float32(0.02), jchk)
        keys = ("boxes", "probs", "coeffs", "proto") + (("pyramid",) if shared else ())
        model = _HandOver([imgs], [{k: head[k] for k in keys}])
        step = bench.make_fused_step(model, ptrack, IMGSZ)
        got, pmem = step(pmem, torch.from_numpy(frames), 0.02, pchk)
        assert model.calls == 1
        for k in ("boxes", "scores", "valid"):
            np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(ref[k]).astype(np.float32), err_msg=k)
        assert got["mask"].dtype == torch.uint8
        for g, r in zip(got["mask"].numpy(), np.asarray(ref["mask"])):
            assert (g == r).mean() >= MASK_AGREE
        agree = float((got["ids"].numpy() == np.asarray(ref["ids"])).mean())
        assert got["ids"].dtype == torch.uint8 and agree >= BF16_ID_AGREE, agree
        assert pmem.frame_idx == int(jmem.frame_idx) and pmem.write_pos == int(jmem.write_pos)
        n_valid += int(np.asarray(ref["valid"]).sum())
        jchk, pchk = ref["chk"], got["chk"]
    assert n_valid > 0


def test_fused_step_matches_jax_fused_step():
    """The default step: the tracker's own encoder (``_check_fused_step``)."""
    _check_fused_step(shared=False)


def test_shared_fused_step_matches_jax_shared_step():
    """``--shared`` against ``BENCH_SHARED=1``: the tracker's keys from the
    detector's pyramid, with the shipped shared-backbone checkpoint trained on
    YOLOv10n's pyramid (``tracker_shared_n_trained.msgpack``)
    (``_check_fused_step``)."""
    _check_fused_step(shared=True)


@pytest.mark.parametrize("version,imgsz", [("v10", (96, 64)), ("v11", (64, 128)), ("v8", (64, 64))])
def test_pyramid_matches_jax(version, imgsz):
    """``YOLOModel``'s ``pyramid`` output (P3, P4, P5, channels-last) against the
    JAX model's within 1e-4 (fp32, seeded variables), and its widths are
    ``pyramid_channels_for``'s."""
    from tests.torch_parity import port_model_from_jax, seeded_jax_variables

    jm = JaxYOLOModel(version=version, scale="n", nc=1, task="segment")
    x = np.random.default_rng(3).uniform(0, 1, (2, *imgsz, 3)).astype(np.float32)
    variables = seeded_jax_variables(jm, jnp.asarray(x[:1]), seed=4)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))["pyramid"]
    with torch.no_grad():
        got = port_model_from_jax(version, "n", 1, "segment", variables)(torch.from_numpy(x))["pyramid"]
    assert sorted(got) == ["P3", "P4", "P5"]
    for k, c, stride in zip(("P3", "P4", "P5"), pyramid_channels_for(version, "n"), (8, 16, 32)):
        assert tuple(got[k].shape) == ref[k].shape == (2, imgsz[0] // stride, imgsz[1] // stride, c), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4, err_msg=k)


def test_bf16_tracker_with_bf16_affinity_stays_close_to_jax():
    """The port's bf16 tracker on its kernel path (long-term off) against the JAX
    bf16 tracker with ``affinity_bf16=True`` over a detection, three steps and a
    window: probabilities within BF16_PROB_TOL, id maps ≥ BF16_ID_AGREE equal."""
    from yolo_puncture_tpu.track import ObjectInfo as JaxObjectInfo
    from yolo_puncture_tpu_torch.track import ObjectInfo

    kw = dict(image_size=(64, 112), max_objects=2, mem_frames=4, mem_every=4, enable_long_term=False,
              affinity_bf16=True)
    jcore = JaxTrackerCore(variables=_needle(), dtype=jnp.bfloat16, **kw)
    pcore = TrackerCore(variables=_needle(), dtype=torch.bfloat16, device="cpu", **kw)
    frames = _frames(12)[..., ::-1].copy()
    mask = np.zeros(FRAME_HW, np.int32)
    mask[30:44, 20:80] = 1
    out = {}
    for core, info in ((jcore, JaxObjectInfo), (pcore, ObjectInfo)):
        probs = [core.incorporate_detection(frames[0], mask, [info(id=1)])]
        probs += [core.step(f) for f in frames[1:4]]
        probs += list(core.step_batch(list(frames[4:12])))
        out[core] = np.stack([np.asarray(p) for p in probs])
    err = float(np.abs(out[pcore] - out[jcore]).max())
    agree = float((out[pcore].argmax(1) == out[jcore].argmax(1)).mean())
    print(f"bf16 tracker vs JAX bf16 with bf16 affinity: max abs prob diff {err:.4g}, ids equal {agree:.5f}")
    assert err <= BF16_PROB_TOL and agree >= BF16_ID_AGREE


def test_bench_runs_on_the_cpu_at_a_toy_size(monkeypatch):
    """``run_bench`` (what ``python -m yolo_puncture_tpu_torch.bench`` runs) at a
    toy size on the CPU: ``bench.py``'s result keys and the median step time."""
    import json

    monkeypatch.setattr(bench, "FRAME_HW", FRAME_HW)
    monkeypatch.setattr(bench, "MIN_SIDE", MIN_SIDE)
    res, details = bench.run_bench(batch=4, iters=2, imgsz=64, track=True, device="cpu")
    assert res["metric"] == "frames/sec/chip at 640x640 (YOLOv10-S seg+DEVA)" and res["unit"] == "frames/sec"
    assert res["value"] > 0 and len(details["steps_ms"]) == 2 and np.isfinite(details["chk"])
    assert res["median_step_ms"] == float(np.median(details["steps_ms"]))
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "median_step_ms"}
    json.dumps(res)
