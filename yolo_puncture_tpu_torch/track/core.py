"""TrackerCore: the temporal mask-propagation engine (DEVA inference core surface).

Counterpart of ``yolo_puncture_tpu/track/core.py``.  ``step(image)`` propagates
one frame through memory attention; ``incorporate_detection(image, mask,
segments_info)`` merges new detections with the propagated objects and writes
the memory; ``step_batch(images)`` propagates a run of frames in windows of
``mem_every``; the temporary buffer and ``vote_in_temporary_buffer`` serve
semi-online voting, with ``config["align_voting"]`` optionally aligning each
buffered detection to the keyframe first (``align_mask_to``: one key-affinity
hop; ``propagate_mask_backward``: the tracker stepped backwards through the
buffer on a scratch memory).

What differs from the JAX package, on purpose:

  * there is no ``jit``: the device programs are plain methods, ``lax.scan`` /
    ``lax.cond`` / ``vmap`` are Python loops, ``if``s and batch dimensions, and
    the methods that took ``variables`` first take none (the weights live in
    ``self.net``);
  * the constructor has no ``flash_readout``, ``pallas_tail`` or ``subpix_tail``:
    the fused decode tail and the streaming readout are the step, not options.
    Every decode tail is ``ops/kernels/decode_tail`` and every readout that needs
    no usage (``enable_long_term=False``) is ``ops/kernels/memory_readout``: the
    CUDA kernels on the card, their plain versions on the CPU.  With
    ``enable_long_term=True`` the readout must return the attention usage, which
    the kernel does not compute, and stays ``network.memory_readout_dense``;
  * tensors are channel-first (``network.py``); ``write_pos``, ``lt_pos`` and
    ``frame_idx`` are Python ints (``memory.py``);
  * ``quantized_memory`` is not ported yet and raises;
  * ``affinity_bf16`` rounds the readout's logits to bf16 before the softmax, as
    the JAX package's dense readout rounds its (Q, M) affinity: on the
    long-term path in ``memory_readout_dense``, on the kernel path inside the
    kernel's online softmax (``ops/kernels/memory_readout``), which never stores
    the affinity but rounds each logit the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.ops.kernels.memory_readout import memory_readout as memory_readout_kernel
from yolo_puncture_tpu_torch.ops.masks import _linear_weight_mat, _resample, upsample_bilinear_matmul
from yolo_puncture_tpu_torch.ops.resize import resize_linear_u8, resize_nearest
from yolo_puncture_tpu_torch.track.memory import MemoryState, consolidate, engaged, init_memory, write_memory
from yolo_puncture_tpu_torch.track.network import (
    PropagationNetwork,
    memory_readout_dense,
    soft_aggregate,
)
from yolo_puncture_tpu_torch.utils.convert import (
    export_tracker_state_dict,
    load_tracker_state_dict,
    read_msgpack,
)
from yolo_puncture_tpu_torch.utils.device import resolve_device


def match_detections(prop_masks, active, det_onehot, det_valid, overlap_thresh: float = 0.6):
    """Greedy identity matching of detections against propagated masks.

    prop_masks (No, H, W) {0, 1}; active (No,) bool; det_onehot (No, H, W);
    det_valid (No,) bool.  In the order given, a detection merges into an active
    slot when IoU > 0.5, or the slot's propagated mask is covered by it
    (intersection / propagated area > ``overlap_thresh``), or IoU > 0.25;
    otherwise it claims the first free slot.  One detection per slot per call;
    a detection contained (> ``overlap_thresh``) in an earlier used detection is
    dropped as a duplicate; an active slot that no detection claimed and whose
    mask is covered by a claimed detection is a ghost and is deactivated.

    The overlaps are sums over pixels on the masks' device; the greedy loop runs
    on the host over the resulting (No, No) tables, one copy off the device.
    Returns (merged_masks (No, H, W), active (No,) bool, det_to_slot (No,) int64),
    tensors on the masks' device.
    """
    No = prop_masks.shape[0]
    dev = prop_masks.device
    prop = prop_masks.float().flatten(1)
    det = det_onehot.float().flatten(1)
    prop_area, det_area = prop.sum(1), det.sum(1)
    inter = prop @ det.T
    union = prop_area[:, None] + det_area[None, :] - inter
    pair_ok = active[:, None] & det_valid[None, :]
    minus = inter.new_tensor(-1.0)
    iou = torch.where(pair_ok, inter / union.clamp_min(1.0), minus)
    covered_by = torch.where(pair_ok, inter / prop_area[:, None].clamp_min(1.0), minus)
    dcontain = (det @ det.T) / torch.minimum(det_area[:, None], det_area[None, :]).clamp_min(1.0)
    tables = torch.stack([iou, covered_by, dcontain]).cpu().numpy()
    iou_h, cov_h, dcontain_h = tables
    act = active.cpu().numpy().copy()
    dvalid = det_valid.cpu().numpy()
    thresh = np.float32(overlap_thresh)

    det_to_slot = np.full((No,), -1, np.int64)
    claimed = np.zeros((No,), bool)
    used = np.zeros((No,), bool)
    source = np.full((No,), -1, np.int64)          # slot → detection whose mask it takes
    for j in range(No):
        dup = bool(np.any(used & dvalid & (dcontain_h[:, j] > thresh)))
        col_iou = np.where(claimed, np.float32(-1), iou_h[:, j])
        col_cov = np.where(claimed, np.float32(-1), cov_h[:, j])
        best_iou, best_cov = int(np.argmax(col_iou)), int(np.argmax(col_cov))
        m_iou = col_iou[best_iou] > np.float32(0.5)
        m_cov = col_cov[best_cov] > thresh
        m_weak = col_iou[best_iou] > np.float32(0.25)
        matched = bool((m_iou or m_cov or m_weak) and dvalid[j] and not dup)
        best = best_iou if (m_iou or (not m_cov and m_weak)) else best_cov
        free = int(np.argmin(act))                   # first inactive slot
        new_obj = bool(dvalid[j] and not matched and not dup and not act[free])
        if matched or new_obj:
            slot = best if matched else free
            source[slot] = j
            act[slot] = claimed[slot] = used[j] = True
            det_to_slot[j] = slot
    covered = np.max(np.where(used[None, :], cov_h, np.float32(-1)), axis=1)
    act = act & ~(act & ~claimed & (covered > thresh))

    src = torch.from_numpy(source).to(dev)
    act_t = torch.from_numpy(act).to(dev)
    merged = torch.where((src >= 0)[:, None, None], det_onehot.float()[src.clamp_min(0)],
                         prop_masks.float() * active[:, None, None])
    merged = merged * act_t[:, None, None]
    return merged, act_t, torch.from_numpy(det_to_slot).to(dev)


@dataclasses.dataclass
class ObjectInfo:
    id: int
    score: float = 1.0
    category_id: int = 0


@dataclasses.dataclass
class FrameInfo:
    image: np.ndarray
    mask: Optional[np.ndarray]
    segments_info: Optional[List[ObjectInfo]]
    ti: int
    info: dict
    image_np: Optional[np.ndarray] = None

    @property
    def name(self):
        return self.info["frame"][0]


class ObjectManager:
    """Slot index ↔ object id."""

    def __init__(self, max_objects: int):
        self.max_objects = max_objects
        self.slot_to_info: Dict[int, ObjectInfo] = {}
        self._next_id = 1

    def allocate(self, slot: int, info: Optional[ObjectInfo] = None) -> ObjectInfo:
        if info is None:
            info = ObjectInfo(id=self._next_id)
        self._next_id = max(self._next_id, info.id + 1)
        self.slot_to_info[slot] = info
        return info

    def release(self, slot: int) -> None:
        self.slot_to_info.pop(slot, None)

    @property
    def all_obj_ids(self):
        return [o.id for o in self.slot_to_info.values()]


class TrackerCore:
    """variables: ``None`` (seeded random init), the path of a flax msgpack
    checkpoint, the tracker's variable tree (``params`` / ``batch_stats``), or a
    state dict of ``PropagationNetwork``.  device: ``None`` (the card) or
    ``"cpu"``; without a card only ``"cpu"`` works."""

    def __init__(
        self,
        config: Optional[dict] = None,
        variables=None,
        image_size: Tuple[int, int] = (480, 864),
        max_objects: int = 8,
        mem_frames: int = 16,
        mem_every: int = 5,
        top_k: int = 30,
        num_prototypes: int = 128,
        max_long_term_elements: int = 4096,
        enable_long_term: bool = True,
        dtype=torch.float32,
        seed: int = 0,
        pyramid_adapter: bool = False,
        pyramid_channels=(128, 256, 512),
        quantized_memory: bool = False,
        exact_windows: bool = True,
        affinity_bf16: bool = False,
        device=None,
    ):
        self.config = config or {}
        if self.config.get("quantized_memory", quantized_memory):
            raise NotImplementedError("quantized_memory (the int8 working ring) is not ported yet")
        self.device = resolve_device(device)
        # exact_windows: the windowed paths thread the sensory GRU through every
        # frame, which is the per-frame step() at windowed throughput; False
        # updates it once per window from the last frame
        self.exact_windows = bool(self.config.get("exact_windows", exact_windows))
        self.affinity_bf16 = bool(self.config.get("affinity_bf16", affinity_bf16))
        self.mem_every = int(self.config.get("mem_every", mem_every))
        self.top_k = int(self.config.get("top_k", top_k))
        self.num_prototypes = int(self.config.get("num_prototypes", num_prototypes))
        self.enable_long_term = bool(self.config.get("enable_long_term", enable_long_term))
        lt_capacity = min(int(self.config.get("max_long_term_elements", max_long_term_elements)), 8192)
        if not self.enable_long_term:
            lt_capacity = 8  # vestigial slots, never valid: one shape for both modes
        self.max_objects = max_objects
        h, w = image_size
        if h % 16 or w % 16:
            raise ValueError(f"image_size must be a multiple of 16, got {image_size}")
        self.image_size = (h, w)
        self.h16, self.w16 = h // 16, w // 16
        self.num_prototypes = min(self.num_prototypes, self.h16 * self.w16)
        if self.enable_long_term and lt_capacity < self.num_prototypes:
            # consolidate() writes num_prototypes entries per eviction; a smaller
            # bank would scatter onto duplicate slots
            raise ValueError(
                f"max_long_term_elements ({lt_capacity}) must be >= num_prototypes ({self.num_prototypes})"
            )
        self.dtype = dtype
        self.pyramid_adapter = bool(pyramid_adapter)
        self.net = PropagationNetwork(with_pyramid_adapter=self.pyramid_adapter,
                                      pyramid_channels=tuple(pyramid_channels))
        if variables is None:
            self.net.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            if isinstance(variables, (str, bytes)):
                variables = read_msgpack(variables)
            if isinstance(variables, Mapping) and "params" in variables:
                variables = export_tracker_state_dict(variables)
            load_tracker_state_dict(self.net, variables)
        self.net.to(device=self.device, dtype=dtype).eval()
        self.memory: MemoryState = init_memory(
            self.h16, self.w16, max_objects, mem_frames, dtype, num_prototypes=lt_capacity,
            value_dim=self.net.value_dim, device=self.device,
        )
        self.object_manager = ObjectManager(max_objects)
        # an object unmatched for this many incorporate calls in a row is deleted
        self.max_missed = int(self.config.get("max_missed_detection_count", 10))
        self.overlap_suppress = float(self.config.get("overlap_suppress", 0.6))
        self._missed: Dict[int, int] = {}

        self.frame_buffer: List[FrameInfo] = []
        self.next_voting_frame = 0
        self.curr_ti = -1
        self._long_id = False

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _encode1(self, image):
        """One frame (3, H, W) → (key (Ck, H16, W16), its skips)."""
        key, skips = self.net.encode_key(image[None])
        return key[0], {k: v[0] for k, v in skips.items()}

    def _memory_bank(self, memory: MemoryState):
        """[working ring ‖ long-term prototypes] as flat keys (M, Ck), values
        (No, M, Cv) and validity per element (M,)."""
        T, HW = memory.keys.shape[:2]
        keys = torch.cat([memory.keys.reshape(T * HW, -1), memory.lt_keys], 0)
        vals = torch.cat([memory.values.reshape(self.max_objects, T * HW, -1), memory.lt_values], 1)
        valid = torch.cat([memory.valid.repeat_interleave(HW), memory.lt_valid])
        return keys, vals, valid

    def _readout(self, q, memory: MemoryState):
        """q (Q, Ck) → (readout (No, Q, Cv), memory with the usage accumulated)."""
        keys, vals, valid = self._memory_bank(memory)
        if not self.enable_long_term:
            # nothing consumes the usage: the streaming kernel
            return memory_readout_kernel(q, keys, vals, valid, affinity_bf16=self.affinity_bf16), memory
        readout, usage = memory_readout_dense(q, keys, vals, valid, return_usage=True,
                                              affinity_bf16=self.affinity_bf16)
        T, HW = memory.keys.shape[:2]
        return readout, memory._replace(usage=memory.usage + usage[: T * HW].reshape(T, HW))

    def _read(self, key, memory: MemoryState):
        """key (Ck, H16, W16) → (readout (No, Cv, H16, W16), memory)."""
        readout, memory = self._readout(key.flatten(1).T.contiguous(), memory)
        readout = readout.reshape(self.max_objects, self.h16, self.w16, -1)
        return readout.permute(0, 3, 1, 2), memory

    def _read_window(self, keys_w, memory: MemoryState):
        """One readout for a whole window: the memory is constant between writes,
        so the queries of all w frames stack.  keys_w (w, Ck, H16, W16) →
        (readout (w, No, Cv, H16, W16), memory)."""
        w = keys_w.shape[0]
        q = keys_w.flatten(2).transpose(1, 2).reshape(w * self.h16 * self.w16, -1).contiguous()
        readout, memory = self._readout(q, memory)
        readout = readout.reshape(self.max_objects, w, self.h16, self.w16, -1)
        return readout.permute(1, 0, 4, 2, 3), memory

    def _propagate_scan_core(self, memory: MemoryState, keys_w, f16_w, exact: bool, any_active: bool):
        """The memory-coupled part of one window: readout → decoder head → sensory
        update → ring write from the last frame's stride-16 mask.  The decode tail
        depends on the memory only through the hidden state, so callers run it
        batched afterwards (``net.decode_tail``, the fused kernel).

        ``exact=False``: every head reads the window-start sensory and the GRU
        updates once from the last frame.  ``exact=True``: head and GRU thread
        through the w frames one by one, as the per-frame ``step`` does, while
        the readout stays batched (the ring only changes at the window's end).

        keys_w (w, Ck, H16, W16); f16_w (w, C, H16, W16).  ``any_active``: whether
        any slot of ``memory`` is active, which decides the write; the caller
        reads it from the device once for all its windows.  Returns (memory,
        hidden (w, No, C, H16, W16), logits16 (w, No, H16, W16))."""
        readout, memory = self._read_window(keys_w, memory)
        w = keys_w.shape[0]
        if exact:
            sensory, hiddens, logits = memory.sensory, [], []
            for i in range(w):
                hidden_i, logits16_i = self.net.decode_head(readout[i], sensory)
                sensory = self.net.update_sensory(sensory, hidden_i)
                hiddens.append(hidden_i)
                logits.append(logits16_i)
            hidden, logits16 = torch.stack(hiddens), torch.stack(logits)
        else:
            hidden, logits16 = self.net.decode_head(
                readout.flatten(0, 1), memory.sensory.repeat(w, 1, 1, 1)
            )
            hidden = hidden.reshape(w, self.max_objects, *hidden.shape[1:])
            logits16 = logits16.reshape(w, self.max_objects, *logits16.shape[1:])
            sensory = self.net.update_sensory(memory.sensory, hidden[-1])
        prob16_last = soft_aggregate(logits16[-1], memory.active.to(logits16.dtype))
        memory = memory._replace(sensory=sensory)
        if any_active:
            if self.enable_long_term and bool(memory.valid[memory.write_pos]):
                memory = consolidate(memory, self.num_prototypes)
            memory = self._write(memory, keys_w[-1], f16_w[-1], prob16_last[1:])
        return memory._replace(frame_idx=memory.frame_idx + w), hidden, logits16

    def propagate_window(self, memory: MemoryState, keys_w, skips_w, exact=None,
                         return_logits: bool = False):
        """Propagate a window of w frames: one readout against the window-start
        memory, one ring write from the last frame (cadence w ≡ ``mem_every``).
        With ``exact`` (default ``self.exact_windows``) the result equals w calls
        of ``step`` when ``w == mem_every`` and the window starts right after a
        write frame (``memory.frame_idx % mem_every == 1``).

        keys_w (w, Ck, H16, W16); skips_w a dict of (w, …) tensors: f16 and
        either f4 / f8 or the projected f4p / f8p.  Returns (probs (w, No+1, H4,
        W4), memory) or, with ``return_logits``, (logits (w, No, H4, W4), memory)
        for callers that upsample the logits before aggregating, as ``step`` does."""
        proj = skips_w if "f4p" in skips_w else self.net.project_skips(skips_w)
        act = memory.active
        memory, hidden, _ = self._propagate_scan_core(
            memory, keys_w, skips_w["f16"], exact=self.exact_windows if exact is None else exact,
            any_active=bool(act.any()),
        )
        logits_s4 = self.net.decode_tail(hidden, proj["f8p"], proj["f4p"])
        if return_logits:
            return logits_s4, memory
        return soft_aggregate(logits_s4, act.to(logits_s4.dtype)), memory

    def _decode_and_update(self, memory, skips0, readout, full_res: bool = True):
        logits, hidden, logits_s16 = self.net.decode(readout, skips0, memory.sensory, full_res=full_res)
        sensory = self.net.update_sensory(memory.sensory, hidden)
        act = memory.active.to(logits.dtype)
        return soft_aggregate(logits, act), soft_aggregate(logits_s16, act.to(logits_s16.dtype)), sensory

    def _write(self, memory, key, f16, fg_s16):
        """Encode the value of this frame for every object and write the ring.
        fg_s16 (No, H16, W16): per-object foreground probabilities at stride 16."""
        value = self.net.encode_value(f16, fg_s16[:, None].to(f16.dtype), memory.sensory)
        return write_memory(memory, key.flatten(1).T, value.flatten(2).transpose(1, 2))

    def _step_impl(self, memory: MemoryState, image):
        key, skips0 = self._encode1(image)
        return self._step_from_feats(memory, key, skips0)

    def _step_from_feats(self, memory: MemoryState, key, skips0, readout=None, full_res: bool = True):
        """Propagate one frame from its features (key (Ck, H16, W16), skips of one
        frame).  Returns (prob (No+1, H, W), memory); with ``full_res=False`` prob
        stays at stride 4, (No+1, H/4, W/4)."""
        if readout is None:
            readout, memory = self._read(key, memory)
        prob, prob_s16, sensory = self._decode_and_update(memory, skips0, readout, full_res=full_res)
        memory = memory._replace(sensory=sensory)
        if memory.frame_idx % self.mem_every == 0 and bool(memory.active.any()):
            # before an occupied slot is overwritten, its most used elements
            # move to the long-term bank
            if self.enable_long_term and bool(memory.valid[memory.write_pos]):
                memory = consolidate(memory, self.num_prototypes)
            memory = self._write(memory, key, skips0["f16"], prob_s16[1:])
        return prob, memory._replace(frame_idx=memory.frame_idx + 1)

    def _incorporate_impl(self, memory: MemoryState, image, det_onehot, det_valid):
        key, skips0 = self._encode1(image)
        return self._incorporate_from_feats(memory, key, skips0, det_onehot, det_valid)

    def _incorporate_from_feats(self, memory: MemoryState, key, skips0, det_onehot, det_valid,
                                readout=None):
        """det_onehot (No, H, W) float: detection masks stacked into slots in any
        order; det_valid (No,) bool.  Returns (prob, memory, det_to_slot)."""
        if readout is None:
            readout, memory = self._read(key, memory)
        prob, _, sensory = self._decode_and_update(memory, skips0, readout)
        prop_masks = (prob[1:] > 0.5).float()
        merged, active, det_to_slot = match_detections(
            prop_masks, memory.active, det_onehot, det_valid, overlap_thresh=self.overlap_suppress
        )
        memory = memory._replace(sensory=sensory, active=active)
        # the output is re-aggregated from the merged masks: detections are authoritative
        m = merged.clamp(1e-6, 1 - 1e-6)
        prob_out = soft_aggregate(torch.log(m / (1 - m)), active.float())
        # the write is unconditional (a new reference frame) and takes the merged
        # detection mask, shrunk to stride 16 with an antialiased linear filter
        h, w = self.image_size
        wh = _linear_weight_mat(h, self.h16, float(np.float32(self.h16 / h)), 0.0, prob_out.device)
        ww = _linear_weight_mat(w, self.w16, float(np.float32(self.w16 / w)), 0.0, prob_out.device)
        fg_s16 = torch.matmul(wh.T, torch.matmul(prob_out[1:], ww))
        memory = self._write(memory, key, skips0["f16"], fg_s16)
        return prob_out, memory._replace(frame_idx=memory.frame_idx + 1), det_to_slot

    def _align_impl(self, img_dst, img_src, onehot_src):
        """Per-object masks from the source frame's coordinates into the
        destination frame's, by key affinity: the destination's keys, scaled by 4
        to sharpen the softmax towards one correspondence, read the source's keys
        with the masks at stride 16 as values of width 1 (``jax.image.resize``'s
        antialiased bilinear down, the matmul bilinear up).  The readout is the
        plain dense one, as in the JAX package: the kernel is compiled for values
        of width 128.  img_* (3, H, W); onehot_src (No, H, W) → (No, H, W) fp32."""
        keys, _ = self.net.encode_key(torch.stack([img_dst, img_src]))
        q = keys[0].flatten(1).T * 4.0                                 # destination queries (HW, Ck)
        k = keys[1].flatten(1).T
        h, w = self.image_size
        dev = onehot_src.device
        wh = _linear_weight_mat(h, self.h16, float(np.float32(self.h16 / h)), 0.0, dev)
        ww = _linear_weight_mat(w, self.w16, float(np.float32(self.w16 / w)), 0.0, dev)
        No = onehot_src.shape[0]
        m16 = _resample(onehot_src, wh, ww).reshape(No, -1, 1).to(keys.dtype)
        valid = torch.ones(k.shape[0], dtype=torch.bool, device=dev)
        probs = memory_readout_dense(q, k, m16, valid).reshape(No, self.h16, self.w16)
        return upsample_bilinear_matmul(probs.float(), h, w)

    def _pack_id_mask(self, mask: np.ndarray):
        """Integer id mask → (one-hot (No, H, W) fp32, valid (No,), the mask at
        ``image_size``, its ids), nearest-resized to ``image_size`` if needed."""
        h, w = self.image_size
        m = self._resize_id_mask(mask)
        ids = [i for i in np.unique(m) if i != 0][: self.max_objects]
        onehot = np.zeros((self.max_objects, h, w), np.float32)
        valid = np.zeros((self.max_objects,), bool)
        for j, i in enumerate(ids):
            onehot[j] = m == i
            valid[j] = True
        return onehot, valid, m, ids

    def encode_pyramid(self, p3, p4, p5, content_box=None):
        """Shared-backbone encode: detector pyramid (B, C, h, w) → (keys (B, Ck,
        H16, W16), skips).  Needs ``pyramid_adapter=True``."""
        if not self.pyramid_adapter:
            raise ValueError("TrackerCore(pyramid_adapter=True) required")
        return self.net.encode_from_pyramid(p3, p4, p5, (self.h16, self.w16), content_box=content_box)

    def propagate_frames(self, memory: MemoryState, keys, skips, window: int, exact=None,
                         return_logits: bool = False, full_res_ids: bool = False):
        """``propagate_window`` over B = nw·window encoded frames, the decode tail
        batched over all B afterwards.  ``exact=True`` needs ``window ==
        mem_every``: another window changes the ring-write cadence against
        ``step``.  keys (B, Ck, H16, W16); skips a dict of (B, …) tensors.

        Returns (memory, ids_s4 (B, H4, W4) uint8), the argmax id maps at stride
        4; with ``return_logits`` (memory, logits_s4 (B, No, H4, W4)); with
        ``full_res_ids`` (memory, ids (B, H, W) uint8) from the upsampled logits,
        as ``step`` orders it."""
        B = keys.shape[0]
        if B % window:
            raise ValueError(f"batch {B} must be a multiple of window {window}")
        exact = self.exact_windows if exact is None else exact
        if exact and window != self.mem_every:
            raise ValueError(
                f"exact=True requires window == mem_every ({self.mem_every}); got window={window}. "
                f"Pass exact=False for the windowed approximation at this cadence."
            )
        proj = self.net.project_skips(skips)
        act = memory.active
        any_active = bool(act.any())  # the windows do not change it: one wait for the device, not one a window
        hiddens = []
        for i in range(0, B, window):
            memory, hidden, _ = self._propagate_scan_core(
                memory, keys[i:i + window], skips["f16"][i:i + window], exact=exact, any_active=any_active
            )
            hiddens.append(hidden)
        logits_s4 = self.net.decode_tail(torch.cat(hiddens), proj["f8p"], proj["f4p"])
        if return_logits:
            return memory, logits_s4
        actf = act.to(logits_s4.dtype)
        if full_res_ids:
            logits_s4 = upsample_bilinear_matmul(logits_s4, *self.image_size)
        return memory, soft_aggregate(logits_s4, actf).argmax(dim=1).to(torch.uint8)

    def _window_impl(self, memory: MemoryState, images_w):
        """Encode and propagate a window of frames (w, 3, H, W); full-resolution
        probabilities in ``step``'s order: logits upsampled, then aggregated."""
        keys, skips = self.net.encode_key(images_w)
        act = memory.active
        logits_s4, memory = self.propagate_window(memory, keys, skips, return_logits=True)
        logits = upsample_bilinear_matmul(logits_s4, *self.image_size)
        return soft_aggregate(logits, act.to(logits.dtype)), memory

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    def _prep_image(self, image: np.ndarray) -> torch.Tensor:
        """HWC uint8 or float RGB → (3, H, W) in [0, 1] at ``image_size`` on the
        device, resized with cv2's INTER_LINEAR arithmetic."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        t = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img)).to(self.device), self.image_size)
        return (t.float() / 255.0).permute(2, 0, 1).to(self.dtype)

    def _resize_id_mask(self, mask) -> np.ndarray:
        m = np.asarray(mask)
        if m.shape != self.image_size:
            m = resize_nearest(m.astype(np.int32), self.image_size)
        return m

    def encode_frame_features(self, image: np.ndarray):
        """Encode one frame to reusable (key, skips) features."""
        with torch.no_grad():
            return self._encode1(self._prep_image(image))

    @torch.no_grad()
    def propagate_mask_backward(self, images: Sequence[np.ndarray], mask_src: np.ndarray, conf: float = 0.5,
                                feats: Optional[Sequence] = None) -> np.ndarray:
        """The id mask ``mask_src`` of ``images[-1]`` in the coordinates of
        ``images[0]``, by propagation backwards: a scratch memory (zeros of
        ``self.memory``'s shapes) incorporates the detection at the last frame and
        steps through ``images[-2], …, images[0]``; a pixel takes an id where
        that object's slot wins the argmax with probability above ``conf``.
        ``self.memory`` is left as it was.  ``feats``: the frames' features from
        ``encode_frame_features``, for callers that run several chains over one
        buffer."""
        if len(images) < 2:
            raise ValueError("propagate_mask_backward needs [dst, …, src], at least two frames")
        onehot, valid, _, ids = self._pack_id_mask(mask_src)
        dtype = np.asarray(mask_src).dtype
        if not ids:
            return np.zeros(self.image_size, dtype)
        if feats is None:
            feats = [self.encode_frame_features(im) for im in images]
        if len(feats) != len(images):
            raise ValueError(f"{len(feats)} features for {len(images)} frames")
        scratch = MemoryState(**{k: torch.zeros_like(v) if torch.is_tensor(v) else 0
                                 for k, v in vars(self.memory).items()})
        key_s, skips_s = feats[-1]
        prob, scratch, det_to_slot = self._incorporate_from_feats(
            scratch, key_s, skips_s, torch.from_numpy(onehot).to(self.device), torch.from_numpy(valid).to(self.device)
        )
        for key, skips0 in reversed(feats[:-1]):
            prob, scratch = self._step_from_feats(scratch, key, skips0)
        prob = prob.float().cpu().numpy()                     # (No+1, H, W); channel 0 the background
        det_to_slot = det_to_slot.cpu().numpy()
        out = np.zeros(self.image_size, dtype)
        best = prob.argmax(0)
        for j, i in enumerate(ids):
            slot = int(det_to_slot[j])
            if slot >= 0:
                out[(best == slot + 1) & (prob[slot + 1] > conf)] = i
        return out

    @torch.no_grad()
    def align_mask_to(self, image_dst, image_src, mask_src: np.ndarray) -> np.ndarray:
        """Integer id mask in the source frame's coordinates → id mask aligned to
        the destination frame's (ids kept; 0 where no object wins with more than
        0.4), by one key-affinity hop (``_align_impl``)."""
        onehot, _, m, ids = self._pack_id_mask(mask_src)
        probs = self._align_impl(self._prep_image(image_dst), self._prep_image(image_src),
                                 torch.from_numpy(onehot).to(self.device)).cpu().numpy()
        out = np.zeros(self.image_size, m.dtype)
        best, conf = probs.argmax(0), probs.max(0)
        for j, i in enumerate(ids):
            out[(best == j) & (conf > 0.4)] = i
        return out

    @torch.no_grad()
    def step(self, image, mask=None, objects=None):
        """Propagate one frame.  Returns prob (No+1, H, W) numpy."""
        if mask is not None:
            seg_info = ([ObjectInfo(id=i + 1) for i in range(int(np.max(mask)))]
                        if objects is None else objects)
            return self.incorporate_detection(image, mask, seg_info)
        self.curr_ti += 1
        prob, self.memory = self._step_impl(self.memory, self._prep_image(image))
        return prob.float().cpu().numpy()

    @torch.no_grad()
    def step_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Propagate a run of detection-free frames in windows of ``mem_every``;
        a trailing partial window goes through per-frame ``step`` semantics, so no
        padded frame is written.  Returns probs (T, No+1, H, W)."""
        T = len(images)
        h, w = self.image_size
        if T == 0:
            return np.zeros((0, self.max_objects + 1, h, w), np.float32)
        win = max(1, self.mem_every)
        prepped = [self._prep_image(im) for im in images]
        rem = T % win
        outs = []
        for i in range(0, T - rem, win):
            probs, self.memory = self._window_impl(self.memory, torch.stack(prepped[i:i + win]))
            outs.append(probs.float().cpu().numpy())
        for i in range(T - rem, T):
            prob, self.memory = self._step_impl(self.memory, prepped[i])
            outs.append(prob.float().cpu().numpy()[None])
        self.curr_ti += T
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def incorporate_detection(self, image, mask, segments_info, incremental: bool = True):
        """mask: (H, W) integer id mask; id j + 1 is ``segments_info[j]``."""
        self.curr_ti += 1
        img = self._prep_image(image)
        h, w = self.image_size
        m = self._resize_id_mask(mask)
        No = self.max_objects
        infos = list(segments_info or [])[:No]
        onehot = np.zeros((No, h, w), np.float32)
        valid = np.zeros((No,), bool)
        for j in range(len(infos)):
            onehot[j] = m == (j + 1)
            valid[j] = onehot[j].sum() > 0
        prob, self.memory, det_to_slot = self._incorporate_impl(
            self.memory, img, torch.from_numpy(onehot).to(self.device), torch.from_numpy(valid).to(self.device)
        )
        det_to_slot = det_to_slot.cpu().numpy()
        for j, info in enumerate(infos):
            slot = int(det_to_slot[j])
            if slot >= 0 and slot not in self.object_manager.slot_to_info:
                # a new slot gets a fresh id when the incoming segment id is in use
                if info.id in self.object_manager.all_obj_ids:
                    info = ObjectInfo(id=self.object_manager._next_id, score=info.score,
                                      category_id=info.category_id)
                self.object_manager.allocate(slot, info)
        # a ghost slot that matching deactivated is purged at once
        new_active = self.memory.active.cpu().numpy()
        matched = {int(s) for s in det_to_slot if s >= 0}
        for slot in list(self.object_manager.slot_to_info):
            if not new_active[slot] and slot not in matched:
                self._release_slot(slot)
        # an object unmatched for max_missed calls in a row frees its slot
        for slot in list(self.object_manager.slot_to_info):
            if slot in matched:
                self._missed[slot] = 0
            else:
                self._missed[slot] = self._missed.get(slot, 0) + 1
                if self._missed[slot] >= self.max_missed:
                    self._release_slot(slot)
        return prob.float().cpu().numpy()

    def _release_slot(self, slot: int) -> None:
        """Deactivate a slot and zero its memory (in copies: an earlier state a
        caller kept is left as it was), so that an object that takes the slot
        later reads nothing of the deleted one."""
        mem = self.memory
        active, values = mem.active.clone(), mem.values.clone()
        lt_values, sensory = mem.lt_values.clone(), mem.sensory.clone()
        active[slot] = False
        values[slot] = 0
        lt_values[slot] = 0
        sensory[slot] = 0
        self.memory = mem._replace(active=active, values=values, lt_values=lt_values, sensory=sensory)
        self.object_manager.release(slot)
        self._missed.pop(slot, None)

    # -- semi-online buffer and voting ---------------------------------------

    def add_to_temporary_buffer(self, frame_info: FrameInfo):
        self.frame_buffer.append(frame_info)

    def clear_buffer(self):
        self.frame_buffer = []

    def vote_in_temporary_buffer(self, keyframe_selection: str = "first"):
        """Pixel-majority vote over the buffered detection masks.  Objects are
        anchored to the first frame; one survives if its region is detected
        (IoU > 0.5 with some object) in at least half the buffered frames.
        Returns (ti, voted mask, segments_info).

        ``config["align_voting"]`` first moves each buffered detection into the
        keyframe's coordinates: ``"propagate"`` by ``propagate_mask_backward``
        through the buffer (every frame encoded once for all chains), any other
        true value by ``align_mask_to``."""
        if keyframe_selection != "first":
            raise ValueError("only keyframe_selection='first' is supported")
        if not self.frame_buffer:
            raise ValueError("empty voting buffer")
        keyframe = self.frame_buffer[0]
        key_mask = np.asarray(keyframe.mask)
        key_infos = list(keyframe.segments_info or [])
        n_frames = len(self.frame_buffer)
        align = self.config.get("align_voting", False)

        def img_of(fi):
            return fi.image_np if fi.image_np is not None else fi.image

        feat_cache = ([self.encode_frame_features(img_of(f)) for f in self.frame_buffer]
                      if align == "propagate" and key_infos else None)
        votes = {j: 1 for j in range(1, len(key_infos) + 1)}
        for i, fi in enumerate(self.frame_buffer[1:], start=1):
            if not votes:
                break
            m = np.asarray(fi.mask)
            if align == "propagate":
                m = self.propagate_mask_backward([img_of(f) for f in self.frame_buffer[:i + 1]], m,
                                                 feats=feat_cache[:i + 1])
            elif align:
                m = self.align_mask_to(img_of(keyframe), img_of(fi), m)
            if m.shape != key_mask.shape:
                m = resize_nearest(m.astype(np.int32), key_mask.shape)
            for j in list(votes):
                a = key_mask == j
                if not a.any():
                    continue
                ids, counts = np.unique(m[a], return_counts=True)
                best = ids[np.argmax(counts)]
                if best == 0:
                    continue
                b = m == best
                if (a & b).sum() / max((a | b).sum(), 1) > 0.5:
                    votes[j] += 1
        keep = [j for j, v in votes.items() if v >= max(1, (n_frames + 1) // 2)]
        out_mask = np.zeros_like(key_mask)
        new_infos = []
        for new_id, j in enumerate(keep, start=1):
            out_mask[key_mask == j] = new_id
            new_infos.append(key_infos[j - 1])
        return keyframe.ti, out_mask, new_infos

    def enabled_long_id(self):
        self._long_id = True

    @property
    def memory_engaged(self) -> bool:
        return engaged(self.memory)
