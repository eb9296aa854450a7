"""Mask alignment before semi-online voting (``TrackerCore`` ``align_voting``):
the port's ``align_mask_to``, ``propagate_mask_backward`` and
``vote_in_temporary_buffer`` on the CPU against the JAX package's, with the
shipped needle checkpoint, on the same frames (a bright bar that slides across
the buffer, frames of 72×108 resized to the tracker's 64×96 with cv2's
INTER_LINEAR arithmetic on both sides).

Tolerances: id masks ≥ 99.9 % of pixels equal (fp32 convolutions summed in
another order move a probability near a threshold); the voted mask and its
segments exactly.  Both alignments run on a scratch state: the tracker's own
memory, after a real detection and a step, is bit for bit what it was.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import torch_single_thread  # noqa: F401  (autouse fixture)
from tests.torch_parity import NEEDLE_CHECKPOINT, repo_path
from yolo_puncture_tpu.track import core as jc
from yolo_puncture_tpu_torch.track import core as tc

H, W = 64, 96
FRAME_HW = (72, 108)
ID_AGREE = 0.999


def _bar_frames(xs, seed, obj_id=3):
    """uint8 RGB frames of FRAME_HW with a bright bar at each x, and the id masks
    (id 3 by default: ids are kept, not renumbered)."""
    rng = np.random.default_rng(seed)
    frames, masks = [], []
    for x in xs:
        f = (rng.uniform(0, 0.1, (*FRAME_HW, 3)) * 255).astype(np.uint8)
        f[22:50, x:x + 22] = 230
        m = np.zeros(FRAME_HW, np.int32)
        m[22:50, x:x + 22] = obj_id
        frames.append(f)
        masks.append(m)
    return frames, masks


def _pair(config=None):
    kw = dict(image_size=(H, W), max_objects=4, mem_frames=4, mem_every=2, enable_long_term=False,
              variables=repo_path(NEEDLE_CHECKPOINT), config=config)
    return jc.TrackerCore(**kw), tc.TrackerCore(device="cpu", **kw)


def _engage(j, t):
    """A detection and one step on both trackers, so that their memory is not empty."""
    frames, masks = _bar_frames([20, 26], seed=1)
    j.incorporate_detection(frames[0], masks[0], [jc.ObjectInfo(id=3)])
    t.incorporate_detection(frames[0], masks[0], [tc.ObjectInfo(id=3)])
    j.step(frames[1])
    t.step(frames[1])


def _memory_snapshot(t):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in vars(t.memory).items()}


def _assert_memory_unchanged(t, before):
    for k, v in vars(t.memory).items():
        if torch.is_tensor(v):
            assert torch.equal(v, before[k]), k
        else:
            assert v == before[k], k


def _assert_ids_agree(got, ref):
    assert got.shape == ref.shape == (H, W) and got.dtype == ref.dtype
    assert set(np.unique(got)) <= {0, 3}
    agree = (got == ref).mean()
    assert agree >= ID_AGREE, agree
    assert (got == 3).sum() > 0


def test_align_mask_to_matches_jax():
    j, t = _pair()
    _engage(j, t)
    before = _memory_snapshot(t)
    (src, dst), (mask_src, _) = _bar_frames([10, 60], seed=7)
    _assert_ids_agree(t.align_mask_to(dst, src, mask_src), j.align_mask_to(dst, src, mask_src))
    _assert_memory_unchanged(t, before)


@pytest.mark.parametrize("chain", [2, 4])
def test_propagate_mask_backward_matches_jax(chain):
    j, t = _pair()
    _engage(j, t)
    before = _memory_snapshot(t)
    frames, masks = _bar_frames([10 + 16 * i for i in range(chain)], seed=11)
    got = t.propagate_mask_backward(frames, masks[-1])
    _assert_ids_agree(got, j.propagate_mask_backward(frames, masks[-1]))
    _assert_memory_unchanged(t, before)
    # the features of each frame, encoded once, give the same projection
    feats = [t.encode_frame_features(f) for f in frames]
    np.testing.assert_array_equal(t.propagate_mask_backward(frames, masks[-1], feats=feats), got)
    empty = t.propagate_mask_backward(frames, np.zeros(FRAME_HW, np.int32))
    assert empty.shape == (H, W) and not empty.any()


@pytest.mark.parametrize("align", ["affinity", "propagate", False])
def test_vote_in_temporary_buffer_with_alignment_matches_jax(align):
    """A bar that moves 18 pixels a frame over a buffer of three: without
    alignment the keyframe's object never overlaps the later detections and is
    voted out; aligned, it survives.  The port votes as the JAX package does."""
    j, t = _pair({"align_voting": align})
    frames, masks = _bar_frames([8, 26, 44], seed=12, obj_id=1)
    out = {}
    for core, mod in ((j, jc), (t, tc)):
        for ti, (f, m) in enumerate(zip(frames, masks)):
            core.add_to_temporary_buffer(mod.FrameInfo(image=f, mask=m, segments_info=[mod.ObjectInfo(id=1)], ti=ti,
                                                       info={"frame": [f"f{ti}"]}, image_np=f))
        out[core] = core.vote_in_temporary_buffer("first")
    (jti, jmask, jinfos), (pti, pmask, pinfos) = out[j], out[t]
    assert pti == jti == 0
    np.testing.assert_array_equal(pmask, jmask)
    assert [i.id for i in pinfos] == [i.id for i in jinfos]
    assert len(pinfos) == (1 if align else 0)
