"""The tracker-quality protocol of the port (``track/quality.py``) against the
JAX package's tool (``tools/eval_tracker_quality.py``).

``make_realistic_clip`` is a numpy/scipy copy of the tool's (the card's machine
has no JAX): the same draws from the same generator give the same clips bit for
bit, and leave the generator in the same state.  The base row ("base
(per-frame, fp32)") on 2 clips of 8 frames at 64×96 with the shipped checkpoint
gives per-frame IoUs within 1e-3 of the tool's, in the tool's order.  The
tool's bench-exact row (bf16) cannot run in XLA's CPU backend (its bf16 logits
upsample outside a compiled program needs a bf16 × bf16 → fp32 dot, which that
backend lacks); ``docs/tracker_quality.md`` records it at the base row's IoU
(0.662 both), and the port's bench-exact row (bf16, ``affinity_bf16``, exact
windows of 4) is held within ``BENCH_EXACT_TOL`` of the tool's base row.  The
"int8 memory" row (the int8 working ring) matches the tool's per frame within
1e-3 IoU, as the base row does.
"""

import numpy as np
import pytest

import tools.eval_tracker_quality as etq
from tests.torch_parity import torch_single_thread  # noqa: F401
from yolo_puncture_tpu.track.core import TrackerCore as JaxTrackerCore
from yolo_puncture_tpu_torch.track import quality

IOU_ATOL = 1e-3
BENCH_EXACT_TOL = 0.01
H, W, T, N_CLIPS = 64, 96, 8, 2


@pytest.mark.parametrize("n_objects,occluder", [(1, False), (2, False), (1, True), (2, True)])
def test_make_realistic_clip_equals_the_tools(n_objects, occluder):
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    got = quality.make_realistic_clip(ra, 6, 48, 80, n_objects=n_objects, occluder=occluder)
    ref = etq.make_realistic_clip(rb, 6, 48, 80, n_objects=n_objects, occluder=occluder)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert ra.random() == rb.random()                     # the generator was drawn alike


def test_protocol_clips_are_the_tools_mix():
    """Clip i has two objects when i is odd and an occluder when i % 4 >= 2, from
    ``default_rng(7)`` (the tool's ``main``)."""
    rng = np.random.default_rng(7)
    ref = [etq.make_realistic_clip(rng, 4, 32, 48, n_objects=2 if i % 2 else 1, occluder=i % 4 >= 2)
           for i in range(4)]
    got = quality.protocol_clips(4, 4, 32, 48)
    for (gi, gm), (ri, rm) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)


def _jax_ious(row, clips, monkeypatch, quantized_memory=False, **kw):
    """The tool's ``eval_config`` for the fp32 ``row``, its per-object IoUs recorded."""
    import jax.numpy as jnp

    seen = []
    real = etq._iou

    def recording(pred, gt):
        v = real(pred, gt)
        seen.append(v)
        return v

    monkeypatch.setattr(etq, "_iou", recording)
    core = JaxTrackerCore(variables=quality.WEIGHTS, image_size=(H, W), max_objects=2, mem_frames=8, mem_every=4,
                          enable_long_term=False, dtype=jnp.float32, quantized_memory=quantized_memory)
    mean = etq.eval_config(row, core, clips, **kw)
    return [v for v in seen if not np.isnan(v)], mean


def test_base_row_per_frame_iou_matches_the_tool(monkeypatch):
    clips = quality.protocol_clips(N_CLIPS, T, H, W)
    ref, ref_mean = _jax_ious("base (per-frame, fp32)", clips, monkeypatch)
    got = quality.eval_config(quality.row_tracker("base (per-frame, fp32)", (H, W), device="cpu"), clips)
    assert len(got) == len(ref) >= N_CLIPS * (T - 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)
    assert abs(np.mean(got) - ref_mean) <= IOU_ATOL


def test_int8_row_per_frame_iou_matches_the_tool(monkeypatch):
    """The "int8 memory" row (the base row's tracker with the int8 ring) against the
    tool's, frame by frame, within 1e-3 IoU."""
    clips = quality.protocol_clips(N_CLIPS, T, H, W)
    ref, ref_mean = _jax_ious("int8 memory", clips, monkeypatch, quantized_memory=True)
    core = quality.row_tracker("int8 memory", (H, W), device="cpu")
    assert core.quantized_memory and str(core.memory.keys.dtype) == "torch.int8"
    got = quality.eval_config(core, clips)
    assert len(got) == len(ref) >= N_CLIPS * (T - 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)
    assert abs(np.mean(got) - ref_mean) <= IOU_ATOL


def test_bench_exact_row_mean_iou_is_the_tools_base_row(monkeypatch):
    clips = quality.protocol_clips(N_CLIPS, T + 1, H, W)          # two full windows of 4 after frame 0
    _, ref_mean = _jax_ious("base (per-frame, fp32)", clips, monkeypatch)
    got = quality.eval_config(quality.row_tracker("bench-exact", (H, W), device="cpu"), clips, window=4, exact=True)
    print(f"bench-exact mean IoU: port {np.mean(got):.5f}, the tool's base row {ref_mean:.5f}")
    assert len(got) >= N_CLIPS * T
    assert abs(np.mean(got) - ref_mean) <= BENCH_EXACT_TOL


def test_run_protocol_reports_both_rows():
    """Every row of ``JAX_MEAN_IOU`` (the two of earlier and "int8 memory"), each
    with the JAX package's figure from ``docs/tracker_quality.md``."""
    res = quality.run_protocol(1, 5, 32, 48, device="cpu")
    assert set(res) == {"base (per-frame, fp32)", "bench-exact", "int8 memory"}
    for name, row in res.items():
        assert 0.0 <= row["mean_iou"] <= 1.0 and row["n"] > 0
        assert row["jax_mean_iou"] == (0.663 if name == "int8 memory" else 0.662)
