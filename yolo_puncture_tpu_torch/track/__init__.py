"""The mask tracker of the port: ``TrackerCore``, its network and its memory, the result
saver of the tracking app (``ResultSaver``, ``flush_buffer``,
``get_input_frame_for_deva``), and the streaming tracker of the benchmark
(``build_bench_tracker``)."""

from yolo_puncture_tpu_torch.ops.letterbox import letterbox_params
from yolo_puncture_tpu_torch.ops.resize import resize_bilinear
from yolo_puncture_tpu_torch.track.core import (  # noqa: F401
    FrameInfo,
    ObjectInfo,
    ObjectManager,
    TrackerCore,
)
from yolo_puncture_tpu_torch.track.memory import MemoryState, init_memory  # noqa: F401
from yolo_puncture_tpu_torch.track.network import PropagationNetwork  # noqa: F401
from yolo_puncture_tpu_torch.track.saver import (  # noqa: F401
    ResultSaver,
    flush_buffer,
    get_input_frame_for_deva,
)
from yolo_puncture_tpu_torch.utils.profiling import span


def reference_tracker_geometry(frame_hw, min_side: int = 480):
    """Processing geometry for a (h0, w0) source frame: the shorter side resized
    to ``min_side`` keeping the aspect, each side padded up to a multiple of 16.
    720p → (480, 864).  Returns (th, tw)."""
    h0, w0 = frame_hw
    r = min_side / min(h0, w0)
    th = -(-round(h0 * r) // 16) * 16
    tw = -(-round(w0 * r) // 16) * 16
    return int(th), int(tw)


def build_bench_tracker(imgsz: int = 640, dtype=None, min_side: int = 480, window: int = 4,
                        frame_hw=(720, 1280), variables=None, device=None, max_objects: int = 4,
                        full_res_ids: bool = False, affinity_bf16: bool = False, pyramid_channels=None,
                        enable_long_term: bool = False, quantized_memory: bool = False):
    """Streaming propagation over frame batches, the JAX package's benchmark helper.

    Returns (initial memory, fn(memory, frames_u8, pyramid=None) → (memory,
    ids)): the caller carries the ring memory from batch to batch.  The tracker is a
    ``TrackerCore`` at ``reference_tracker_geometry(frame_hw, min_side)`` (480×864
    for 720p), ``max_objects`` slots with slot 0 active, a ring of 8, long-term
    memory off unless ``enable_long_term`` (``bench.py``'s ``BENCH_LT=1``: the
    readout is then the dense one, which returns the attention usage), in
    ``dtype`` (fp32 by default), with ``variables`` (a seeded
    random init by default), with ``affinity_bf16`` (the readout's logits
    rounded to bf16, as ``bench.py``'s fused step sets it), with the int8 working
    ring when ``quantized_memory`` (``bench.py``'s ``BENCH_INT8=1``: the dense int8
    readout in place of the readout kernel); ``fn.core`` is that tracker.  ``fn`` takes BGR or
    RGB uint8 frames (B, h0, w0, 3) on the tracker's device, resizes them with
    ``jax.image.resize``'s bilinear in bf16 (``ops/resize.py resize_bilinear``),
    encodes all B keys at once and then, with ``window > 1``, propagates windows
    of ``window`` frames (ring written every ``window`` frames, exact windows)
    through ``TrackerCore.propagate_frames``; with ``window == 1`` it steps frame
    by frame (ring written every 5 frames).  The id maps are taken at stride 4
    and upsampled ×4 by nearest neighbour, or, with ``full_res_ids``, from the
    logits upsampled to full resolution, as ``step`` orders it (the fused step
    of ``bench.py``): ids (B, H, W) uint8.  There is no ``jit``.

    With ``pyramid_channels`` (the detector's (C3, C4, C5),
    ``models/yolo.py pyramid_channels_for``) the tracker is the shared-backbone
    one of ``bench.py``'s ``BENCH_SHARED=1``: ``TrackerCore(pyramid_adapter=True)``,
    whose keys come from ``encode_pyramid`` over ``pyramid``, the detector's
    {P3, P4, P5} output for these frames (channels-last), sampled inside the
    letterbox content of the ``imgsz``² detector input; the frames are not read."""
    import torch

    core = TrackerCore(
        variables=variables,
        image_size=reference_tracker_geometry(frame_hw, min_side),
        max_objects=max_objects, mem_frames=8,
        mem_every=window if window > 1 else 5,
        enable_long_term=enable_long_term, dtype=dtype or torch.float32, device=device, affinity_bf16=affinity_bf16,
        pyramid_adapter=pyramid_channels is not None, pyramid_channels=pyramid_channels or (128, 256, 512),
        quantized_memory=quantized_memory,
    )
    active = core.memory.active.clone()
    active[0] = True                      # one active object, so readout and decode do real work
    mem0 = core.memory._replace(active=active)
    h, w = core.image_size
    # the letterbox content of the detector's square, as fractions of the pyramid's extent
    _, (new_w, new_h), (left, top) = letterbox_params(*frame_hw, imgsz)
    content_box = ((top / imgsz, (top + new_h) / imgsz), (left / imgsz, (left + new_w) / imgsz))

    @torch.no_grad()
    def run(memory, frames_u8, pyramid=None):
        with span("track::encode"):
            if core.pyramid_adapter:
                keys, skips = core.encode_pyramid(*(pyramid[k].permute(0, 3, 1, 2).to(core.dtype)
                                                    for k in ("P3", "P4", "P5")), content_box=content_box)
            else:
                imgs = resize_bilinear(frames_u8.to(torch.bfloat16), (h, w)) / 255.0
                keys, skips = core.net.encode_key(imgs.permute(0, 3, 1, 2).to(core.dtype))
        if window > 1:
            memory, ids = core.propagate_frames(memory, keys, skips, window, full_res_ids=full_res_ids)
        else:
            ids = []
            for i in range(keys.shape[0]):
                prob, memory = core._step_from_feats(memory, keys[i], {k: v[i] for k, v in skips.items()},
                                                     full_res=full_res_ids)
                ids.append(prob.argmax(dim=0).to(torch.uint8))
            ids = torch.stack(ids)
        if not full_res_ids:
            ids = ids.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
        return memory, ids

    run.core = core
    return mem0, run
