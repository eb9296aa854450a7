"""The tracker slice as a whole: the port's ``TrackerCore`` on the CPU against the
JAX package's, on the same frames (a bright bar moving over noise), the same id
masks and the same weights.

``incorporate_detection`` → 5× ``step`` → ``step_batch`` of 5 frames (two windows
of ``mem_every`` = 2 and a trailing frame) → a second ``incorporate_detection``
with a moved and a new object.  Probabilities agree within 1e-3 (fp32
convolutions in another order, carried through eleven recurrent frames), argmax
id maps on ≥ 99.9 % of the pixels, and the slot bookkeeping exactly.  The JAX
side runs its default path (dense readout, exact tail); the port runs its only
path (the readout and decode-tail wrappers' plain versions, here on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import NEEDLE_CHECKPOINT, bar_clip, repo_path, seeded_tracker_variables
from yolo_puncture_tpu.track import core as jc
from yolo_puncture_tpu_torch.track import core as tc

H, W = 64, 96
PROB_ATOL = 1e-3
ID_AGREE = 0.999


def _pair(variables, long_term, **kw):
    """(JAX core, port core) with the same weights.  The long-term ring has two
    slots, so consolidation fires at the third write."""
    geo = dict(image_size=(H, W), max_objects=3, mem_frames=2 if long_term else 4, mem_every=2,
               enable_long_term=long_term, num_prototypes=8, max_long_term_elements=32)
    geo.update(kw)
    return jc.TrackerCore(variables=variables, **geo), tc.TrackerCore(variables=variables, device="cpu", **geo)


def _assert_same_state(t: tc.TrackerCore, j: jc.TrackerCore):
    np.testing.assert_array_equal(t.memory.active.numpy(), np.asarray(j.memory.active))
    np.testing.assert_array_equal(t.memory.valid.numpy(), np.asarray(j.memory.valid))
    np.testing.assert_array_equal(t.memory.lt_valid.numpy(), np.asarray(j.memory.lt_valid))
    assert t.memory.write_pos == int(j.memory.write_pos)
    assert t.memory.lt_pos == int(j.memory.lt_pos)
    assert t.memory.frame_idx == int(j.memory.frame_idx)
    assert t.curr_ti == j.curr_ti
    assert {s: o.id for s, o in t.object_manager.slot_to_info.items()} == \
        {s: o.id for s, o in j.object_manager.slot_to_info.items()}
    assert t.memory_engaged == j.memory_engaged


def _assert_same_probs(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_ATOL)
    assert (got.argmax(-3) == ref.argmax(-3)).mean() >= ID_AGREE


@pytest.mark.parametrize("long_term", [False, True])
@pytest.mark.parametrize("weights", ["seeded", "needle"])
def test_slice_matches_jax(weights, long_term):
    variables = (seeded_tracker_variables(seed=2, image_hw=(H, W)) if weights == "seeded"
                 else repo_path(NEEDLE_CHECKPOINT))
    j, t = _pair(variables, long_term)
    frames, mask = bar_clip(12, H, W, seed=4)

    _assert_same_probs(t.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)]),
                       j.incorporate_detection(frames[0], mask, [jc.ObjectInfo(id=1)]))
    _assert_same_state(t, j)
    for i in range(1, 6):
        _assert_same_probs(t.step(frames[i]), j.step(frames[i]))
        _assert_same_state(t, j)
    _assert_same_probs(t.step_batch(list(frames[6:11])), j.step_batch(list(frames[6:11])))
    _assert_same_state(t, j)
    if long_term:
        assert bool(t.memory.lt_valid.any())                     # consolidation fired
        np.testing.assert_allclose(t.memory.usage.numpy(), np.asarray(j.memory.usage), rtol=0, atol=1e-3)

    # the bar where it is now (matches the tracked object) and a new blob (claims a free slot)
    mask2 = np.roll(mask, 22, axis=1)
    mask2[50:60, 5:20] = 2
    infos = lambda m: [m.ObjectInfo(id=1), m.ObjectInfo(id=1)]  # noqa: E731  (ids collide: the new object gets a fresh one)
    _assert_same_probs(t.incorporate_detection(frames[11], mask2, infos(tc)),
                       j.incorporate_detection(frames[11], mask2, infos(jc)))
    _assert_same_state(t, j)
    assert len(t.object_manager.all_obj_ids) == len(set(t.object_manager.all_obj_ids))
    if weights == "needle":
        assert sorted(t.object_manager.slot_to_info) == [0, 1]   # the trained tracker kept the bar's identity
    np.testing.assert_allclose(t.memory.keys.numpy(), np.asarray(j.memory.keys), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.memory.sensory.permute(0, 2, 3, 1).numpy(), np.asarray(j.memory.sensory),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("long_term", [False, True])
def test_exact_windowed_matches_per_frame(long_term):
    """In the port itself: ``step_batch`` in exact windows equals a per-frame
    ``step`` loop (windows aligned: incorporate leaves frame_idx = 1), 2e-5."""
    variables = seeded_tracker_variables(seed=3, image_hw=(H, W))
    geo = dict(image_size=(H, W), max_objects=3, mem_frames=2, mem_every=3, enable_long_term=long_term,
               num_prototypes=8, max_long_term_elements=32, variables=variables, device="cpu")
    a, b = tc.TrackerCore(**geo), tc.TrackerCore(**geo)
    frames, mask = bar_clip(11, H, W, seed=5)
    for core in (a, b):
        core.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)])
    per_frame = np.stack([a.step(f) for f in frames[1:]])
    windowed = b.step_batch(list(frames[1:]))                       # three windows and a trailing frame
    np.testing.assert_allclose(windowed, per_frame, rtol=0, atol=2e-5)
    for name in ("keys", "values", "sensory", "usage", "lt_keys"):
        np.testing.assert_allclose(getattr(b.memory, name).numpy(), getattr(a.memory, name).numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
    assert (b.memory.write_pos, b.memory.frame_idx, b.memory.lt_pos) == \
        (a.memory.write_pos, a.memory.frame_idx, a.memory.lt_pos)
    assert torch.equal(b.memory.valid, a.memory.valid) and torch.equal(b.memory.lt_valid, a.memory.lt_valid)


def test_int8_ring_tracker_matches_jax():
    """``quantized_memory=True`` with the needle checkpoint: ``incorporate_detection``,
    5× ``step``, ``step_batch`` (two exact windows and a trailing frame) and exact
    ``propagate_frames`` against the JAX int8-ring ``TrackerCore``: probabilities
    1e-3, ids ≥ 99.9 %, the ring's bookkeeping equal, and the readout kernel's
    wrapper never called (the dense int8 readout reads the ring)."""
    from yolo_puncture_tpu_torch.track import core as tcore

    calls = []
    real = tcore.memory_readout_kernel
    tcore.memory_readout_kernel = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        j, t = _pair(repo_path(NEEDLE_CHECKPOINT), False, quantized_memory=True)
        frames, mask = bar_clip(13, H, W, seed=4)
        _assert_same_probs(t.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)]),
                           j.incorporate_detection(frames[0], mask, [jc.ObjectInfo(id=1)]))
        for i in range(1, 6):
            _assert_same_probs(t.step(frames[i]), j.step(frames[i]))
            _assert_same_state(t, j)
        _assert_same_probs(t.step_batch(list(frames[6:11])), j.step_batch(list(frames[6:11])))
        _assert_same_state(t, j)
        assert t.memory.keys.dtype == torch.int8 and int(t.memory.valid.sum()) > 1
        np.testing.assert_allclose(t.memory.usage.numpy(), np.asarray(j.memory.usage), rtol=0, atol=1e-3)
        # exact windows of mem_every through propagate_frames, from the same memory
        timgs = torch.stack([t._prep_image(f) for f in frames[9:13]])
        jimgs = jnp.stack([j._prep_image(f) for f in frames[9:13]])
        with torch.no_grad():
            tkeys, tskips = t.net.encode_key(timgs)
            tmem, tout = t.propagate_frames(t.memory, tkeys, tskips, 2, exact=True, return_logits=True)
        jkeys, jskips = j.net.apply(j.variables, jimgs, method=jc.PropagationNetwork.encode_key)
        jmem, jout = j.propagate_frames(j.variables, j.memory, jkeys, jskips, 2, exact=True, return_logits=True)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=2e-3)
        assert tmem.write_pos == int(jmem.write_pos) and tmem.frame_idx == int(jmem.frame_idx)
        np.testing.assert_allclose(tmem.k_scale.numpy(), np.asarray(jmem.k_scale), rtol=1e-5, atol=0)
    finally:
        tcore.memory_readout_kernel = real
    assert calls == []


def test_inexact_windows_and_propagate_frames_match_jax():
    """The legacy window approximation (``exact_windows`` off through the config
    dict) and the three return forms of ``propagate_frames``."""
    variables = seeded_tracker_variables(seed=6, image_hw=(H, W))
    j, t = _pair(variables, False, config={"exact_windows": False, "mem_every": 2})
    assert t.exact_windows is False and t.mem_every == 2
    frames, mask = bar_clip(6, H, W, seed=7)
    t.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)])
    j.incorporate_detection(frames[0], mask, [jc.ObjectInfo(id=1)])
    _assert_same_probs(t.step_batch(list(frames[1:5])), j.step_batch(list(frames[1:5])))
    _assert_same_state(t, j)

    timgs = torch.stack([t._prep_image(f) for f in frames[1:5]])
    jimgs = jnp.stack([j._prep_image(f) for f in frames[1:5]])
    with torch.no_grad():
        tkeys, tskips = t.net.encode_key(timgs)
    jkeys, jskips = j.net.apply(j.variables, jimgs, method=jc.PropagationNetwork.encode_key)
    for kw in (dict(), dict(return_logits=True), dict(full_res_ids=True)):
        for exact in (False, True):
            with torch.no_grad():
                tmem, tout = t.propagate_frames(t.memory, tkeys, tskips, 2, exact=exact, **kw)
            jmem, jout = j.propagate_frames(j.variables, j.memory, jkeys, jskips, 2, exact=exact, **kw)
            if kw.get("return_logits"):
                np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=2e-3)
            else:
                assert tout.dtype == torch.uint8
                assert (tout.numpy() == np.asarray(jout)).mean() >= ID_AGREE
            assert tmem.frame_idx == int(jmem.frame_idx) and tmem.write_pos == int(jmem.write_pos)
    with pytest.raises(ValueError):
        t.propagate_frames(t.memory, tkeys, tskips, 4, exact=True)
    with pytest.raises(ValueError):
        t.propagate_frames(t.memory, tkeys[:3], tskips, 2)


def _match_case(name):
    No, Hm, Wm = 4, 32, 48
    prop = np.zeros((No, Hm, Wm), np.float32)
    det = np.zeros((No, Hm, Wm), np.float32)
    active = np.array([True, False, False, False])
    valid = np.array([True, False, False, False])
    prop[0, 8:24, 8:24] = 1
    if name == "merge_and_allocate":
        det[0, 9:25, 9:25] = 1
        det[1, 2:8, 36:44] = 1
        valid[1] = True
    elif name == "slots_exhausted":
        active[:] = True
        det[0, :4, 30:34] = 1
    elif name == "one_det_per_slot":
        det[0, 8:24, 8:24] = 1
        det[1, 9:25, 9:25] = 1
        valid[1] = True
    elif name == "coverage_merge":
        prop[0] = 0
        prop[0, 12:18, 12:18] = 1
        det[0, 8:24, 8:24] = 1
    elif name == "ghost_kill":
        prop[1, 9:23, 9:23] = 1
        active[1] = True
        det[0, 8:24, 8:24] = 1
    elif name == "weak_match":
        det[0, 8:24, 16:36] = 1                                   # IoU 0.29: above 0.25, below 0.5
    else:                                                         # fuzz: random rectangles
        rng = np.random.default_rng(int(name.split("_")[1]))
        prop[:] = 0
        for arr in (prop, det):
            for s in range(No):
                y, x = rng.integers(0, Hm - 12), rng.integers(0, Wm - 12)
                arr[s, y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] = 1
        if rng.random() < 0.5:
            det[1] = prop[0]
        active = rng.random(No) < 0.6
        valid = rng.random(No) < 0.7
    return prop, active, det, valid


@pytest.mark.parametrize("case", ["merge_and_allocate", "slots_exhausted", "one_det_per_slot", "coverage_merge",
                                  "ghost_kill", "weak_match"] + [f"fuzz_{i}" for i in range(12)])
def test_match_detections_matches_jax(case):
    prop, active, det, valid = _match_case(case)
    jm, ja, jd = jc.match_detections(*map(jnp.asarray, (prop, active, det, valid)), overlap_thresh=0.6)
    tm, ta, td = tc.match_detections(*map(torch.from_numpy, (prop, active, det, valid)), overlap_thresh=0.6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_step_before_any_detection_is_background():
    t = tc.TrackerCore(image_size=(H, W), max_objects=4, mem_frames=4, mem_every=2, device="cpu")
    prob = t.step(bar_clip(1, H, W)[0][0])
    assert prob.shape == (5, H, W)
    np.testing.assert_allclose(prob.sum(0), 1.0, atol=1e-4)
    assert prob.argmax(0).max() == 0 and not t.memory_engaged
    assert t.step_batch([]).shape == (0, 5, H, W)


def test_object_deletion_and_slot_reuse_match_jax():
    variables = seeded_tracker_variables(seed=8, image_hw=(H, W))
    j, t = _pair(variables, False, config={"max_missed_detection_count": 2})
    frames, mask = bar_clip(4, H, W, seed=9)
    empty = np.zeros((H, W), np.int32)
    for core, m in ((t, tc), (j, jc)):
        core.incorporate_detection(frames[0], mask, [m.ObjectInfo(id=1)])
        kept = core.memory                                         # an earlier state, kept by the caller
        core.incorporate_detection(frames[1], empty, [])
        core.incorporate_detection(frames[2], empty, [])
        assert core.object_manager.slot_to_info == {}
        assert float(np.asarray(kept.values).__abs__().sum()) > 0  # releasing the slot left it as it was
    _assert_same_state(t, j)
    assert float(t.memory.values[0].abs().sum()) == 0 and float(t.memory.sensory[0].abs().sum()) == 0
    t.incorporate_detection(frames[3], mask, [tc.ObjectInfo(id=9)])
    j.incorporate_detection(frames[3], mask, [jc.ObjectInfo(id=9)])
    _assert_same_state(t, j)
    assert t.object_manager.all_obj_ids == [9]


def test_frames_and_masks_of_another_size_are_resized_as_cv2_does():
    """720p-like input: the frame goes through the port's cv2-free INTER_LINEAR,
    the id mask through its INTER_NEAREST; the JAX package uses cv2 for both."""
    variables = seeded_tracker_variables(seed=10, image_hw=(H, W))
    j, t = _pair(variables, False)
    frames, mask = bar_clip(2, 90, 150, seed=11)
    _assert_same_probs(t.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)]),
                       j.incorporate_detection(frames[0], mask, [jc.ObjectInfo(id=1)]))
    _assert_same_probs(t.step(frames[1].astype(np.float32) / 255.0), j.step(frames[1].astype(np.float32) / 255.0))
    np.testing.assert_array_equal(t._prep_image(frames[1]).permute(1, 2, 0).numpy(), np.asarray(j._prep_image(frames[1])))
    _assert_same_probs(t.step(frames[1], mask=mask), j.step(frames[1], mask=mask))   # step with a mask incorporates
    _assert_same_state(t, j)


def test_voting_buffer_matches_jax():
    frames, mask = bar_clip(3, H, W, seed=12)
    shifted, empty = np.roll(mask, 1, axis=1), np.zeros_like(mask)
    small = mask[::2, ::2]                                          # another size: resized to the key frame's
    for seq, n_kept in (([mask, shifted, empty], 1), ([mask, empty, empty], 0), ([mask, small, small], 1)):
        out = []
        for core, m in ((tc.TrackerCore(image_size=(H, W), max_objects=4, mem_frames=4, device="cpu"), tc),
                        (jc.TrackerCore(image_size=(H, W), max_objects=4, mem_frames=4), jc)):
            for i, mk in enumerate(seq):
                core.add_to_temporary_buffer(m.FrameInfo(frames[i], mk, [m.ObjectInfo(id=1)], i,
                                                         {"frame": [f"f{i}.jpg"], "shape": [H, W]}))
            assert core.frame_buffer[0].name == "f0.jpg"
            ti, voted, infos = core.vote_in_temporary_buffer("first")
            core.clear_buffer()
            assert core.frame_buffer == [] and ti == 0 and len(infos) == n_kept
            out.append(voted)
        np.testing.assert_array_equal(out[0], out[1])


def test_constructor_contract():
    if not torch.cuda.is_available():                               # no card: the CPU must be asked for
        with pytest.raises(RuntimeError):
            tc.TrackerCore(image_size=(H, W))
    for align in ("propagate", "affinity"):                          # ported: accepted, as in the JAX package
        assert tc.TrackerCore(image_size=(H, W), config={"align_voting": align}, device="cpu").config["align_voting"]
    q8 = tc.TrackerCore(image_size=(H, W), quantized_memory=True, enable_long_term=False, device="cpu")
    assert q8.quantized_memory and q8.memory.keys.dtype == torch.int8              # the int8 ring is ported
    assert tc.TrackerCore(image_size=(H, W), config={"quantized_memory": True, "enable_long_term": False},
                          device="cpu").quantized_memory
    with pytest.raises(ValueError, match="quantized_memory requires enable_long_term=False"):
        tc.TrackerCore(image_size=(H, W), quantized_memory=True, device="cpu")        # long-term on by default
    with pytest.raises(ValueError):
        tc.TrackerCore(image_size=(H, W), max_objects=2, mem_frames=4, device="cpu",
                       config={"num_prototypes": 24, "max_long_term_elements": 16})
    with pytest.raises(ValueError):
        tc.TrackerCore(image_size=(60, 96), device="cpu")
    with pytest.raises(TypeError):
        tc.TrackerCore(image_size=(H, W), device="cpu", flash_readout=True)   # the kernels are no option
    t = tc.TrackerCore(image_size=(H, W), device="cpu", enable_long_term=False,
                       config={"enable_long_term": True, "top_k": 7, "overlap_suppress": 0.5})
    assert t.enable_long_term and t.top_k == 7 and t.overlap_suppress == 0.5
    t.enabled_long_id()
    assert t._long_id


def test_encode_pyramid_and_frame_features():
    from yolo_puncture_tpu_torch.track import reference_tracker_geometry

    assert reference_tracker_geometry((720, 1280)) == (480, 864)
    assert reference_tracker_geometry((1280, 720)) == (864, 480)
    assert reference_tracker_geometry((1080, 1920)) == (480, 864)
    t = tc.TrackerCore(image_size=(H, W), max_objects=2, mem_frames=2, pyramid_adapter=True, device="cpu")
    rng = np.random.default_rng(0)
    p3, p4, p5 = (torch.from_numpy(rng.standard_normal((1, c, s, s)).astype(np.float32))
                  for c, s in ((128, 8), (256, 4), (512, 2)))
    with torch.no_grad():
        keys, skips = t.encode_pyramid(p3, p4, p5, content_box=((0.125, 0.875), (0.0, 1.0)))
        assert tuple(keys.shape) == (1, 64, H // 16, W // 16) and tuple(skips["f4"].shape) == (1, 128, H // 4, W // 4)
        # propagation from precomputed features: the shared-backbone entry points
        onehot = torch.zeros(2, H, W)
        onehot[0, 20:40, 10:50] = 1
        prob, mem, det_to_slot = t._incorporate_from_feats(
            t.memory, keys[0], {k: v[0] for k, v in skips.items()}, onehot, torch.tensor([True, False]))
        prob2, mem = t._step_from_feats(mem, keys[0], {k: v[0] for k, v in skips.items()})
    assert det_to_slot.tolist() == [0, -1] and tuple(prob2.shape) == (3, H, W) and mem.frame_idx == 2
    key, skips0 = t.encode_frame_features(bar_clip(1, H, W)[0][0])
    assert tuple(key.shape) == (64, H // 16, W // 16) and set(skips0) == {"f4", "f8", "f16"}
    with pytest.raises(ValueError):
        tc.TrackerCore(image_size=(H, W), device="cpu").encode_pyramid(p3, p4, p5)


@pytest.mark.parametrize("long_term", [False, True])
def test_bf16_tracker_stays_close_to_fp32(long_term):
    """``dtype=torch.bfloat16`` (network, memory and both kernels' plain versions in
    bf16, statistics and accumulation in fp32) against fp32 with the needle
    checkpoint: probabilities within 0.1, id maps on ≥ 99 % of the pixels."""
    frames, mask = bar_clip(9, H, W, seed=1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        core = tc.TrackerCore(image_size=(H, W), max_objects=3, mem_frames=2, mem_every=2, enable_long_term=long_term,
                              num_prototypes=8, max_long_term_elements=32, device="cpu", dtype=dtype,
                              variables=repo_path(NEEDLE_CHECKPOINT))
        probs = [core.incorporate_detection(frames[0], mask, [tc.ObjectInfo(id=1)])]
        probs += [core.step(f) for f in frames[1:4]]
        out[dtype] = np.stack(probs + list(core.step_batch(list(frames[4:9]))))
        assert core.memory.values.dtype == dtype and out[dtype].dtype == np.float32
    a, b = out[torch.float32], out[torch.bfloat16]
    assert float(np.abs(a - b).max()) < 0.1
    assert (a.argmax(1) == b.argmax(1)).mean() >= 0.99
