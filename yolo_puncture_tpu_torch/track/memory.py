"""Fixed-shape hierarchical memory of the mask tracker.

Counterpart of ``yolo_puncture_tpu/track/memory.py``:
  * sensory   — per-object GRU hidden at stride 16, updated every frame;
  * working   — ring of ``T`` (key, value) frames; ``valid`` marks filled slots,
                overwritten first in, first out;
  * long-term — prototype bank filled by ``consolidate`` from the slot about to
                be overwritten, chosen by accumulated attention usage.

``MemoryState`` is a dataclass of tensors on one device.  The functions here
return a new state and leave the tensors of the state they were given as they
were (a written ring is a copy), so a caller may keep an earlier state.
``write_pos``, ``lt_pos`` and ``frame_idx`` are Python ints: they only steer
control flow on the host, and reading them costs no synchronisation.

``init_memory(quantized=True)`` keeps the working ring in int8 with scales
beside it, a key scale per slot (``k_scale`` (T,)) and a value scale per object
and slot (``v_scale`` (No, T)); ``write_memory`` quantises at write time, with
``nn/quant.py``'s rounding.  The long-term bank stays in ``dtype``.
"""

from __future__ import annotations

import dataclasses

import torch

from yolo_puncture_tpu_torch.nn.quant import absmax_scale, quantize
from yolo_puncture_tpu_torch.track.network import KEY_DIM, SENSORY_DIM, VALUE_DIM


@dataclasses.dataclass(frozen=True)
class MemoryState:
    keys: torch.Tensor       # (T, HW, Ck)       working ring (fp or int8)
    values: torch.Tensor     # (No, T, HW, Cv)   (fp or int8)
    valid: torch.Tensor      # (T,) bool         slot filled
    write_pos: int           # next ring slot
    usage: torch.Tensor      # (T, HW) fp32      accumulated attention mass per element
    lt_keys: torch.Tensor    # (P, Ck)           long-term prototype bank
    lt_values: torch.Tensor  # (No, P, Cv)
    lt_valid: torch.Tensor   # (P,) bool
    lt_pos: int              # next long-term write position
    sensory: torch.Tensor    # (No, Cs, H16, W16), channel-first
    active: torch.Tensor     # (No,) bool        object slot in use
    frame_idx: int
    k_scale: torch.Tensor    # (T,) fp32         int8 key scale per slot (0 when fp)
    v_scale: torch.Tensor    # (No, T) fp32      int8 value scale per object and slot

    def _replace(self, **changes) -> "MemoryState":
        return dataclasses.replace(self, **changes)


def init_memory(h16: int, w16: int, max_objects: int, mem_frames: int, dtype=torch.float32,
                num_prototypes: int = 128, value_dim: int = VALUE_DIM, quantized: bool = False,
                device=None) -> MemoryState:
    """``quantized=True``: the working ring in int8 (module docstring)."""
    hw = h16 * w16
    ring_dtype = torch.int8 if quantized else dtype

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return MemoryState(
        keys=zeros((mem_frames, hw, KEY_DIM), ring_dtype),
        values=zeros((max_objects, mem_frames, hw, value_dim), ring_dtype),
        valid=zeros((mem_frames,), torch.bool),
        write_pos=0,
        usage=zeros((mem_frames, hw), torch.float32),
        lt_keys=zeros((num_prototypes, KEY_DIM)),
        lt_values=zeros((max_objects, num_prototypes, value_dim)),
        lt_valid=zeros((num_prototypes,), torch.bool),
        lt_pos=0,
        sensory=zeros((max_objects, SENSORY_DIM, h16, w16)),
        active=zeros((max_objects,), torch.bool),
        frame_idx=0,
        k_scale=zeros((mem_frames,), torch.float32),
        v_scale=zeros((max_objects, mem_frames), torch.float32),
    )


def consolidate(state: MemoryState, n_move: int) -> MemoryState:
    """Compress the oldest working slot (the next overwrite target) into
    ``n_move`` prototypes, those with the most accumulated usage, append them to
    the long-term bank first in, first out, and free the slot.  Among equal
    usages the lowest index comes first (a stable descending sort, as
    ``jax.lax.top_k`` orders ties)."""
    oldest = state.write_pos
    idx = torch.sort(state.usage[oldest], descending=True, stable=True).indices[:n_move]
    P = state.lt_keys.shape[0]
    slots = (state.lt_pos + torch.arange(n_move, device=idx.device)) % P
    lt_keys, lt_values, lt_valid = state.lt_keys.clone(), state.lt_values.clone(), state.lt_valid.clone()
    lt_keys[slots] = state.keys[oldest][idx]
    lt_values[:, slots] = state.values[:, oldest][:, idx]
    lt_valid[slots] = True
    valid, usage = state.valid.clone(), state.usage.clone()
    valid[oldest] = False
    usage[oldest] = 0.0
    return state._replace(lt_keys=lt_keys, lt_values=lt_values, lt_valid=lt_valid,
                          lt_pos=(state.lt_pos + n_move) % P, valid=valid, usage=usage)


def write_memory(state: MemoryState, key_flat: torch.Tensor, value_flat: torch.Tensor) -> MemoryState:
    """Write key_flat (HW, Ck) and value_flat (No, HW, Cv) into the ring slot at
    ``write_pos`` and advance it.  An int8 ring quantises them here, the key by
    one scale over the slot, each object's value by its own."""
    pos = state.write_pos
    keys, values, valid = state.keys.clone(), state.values.clone(), state.valid.clone()
    changes = {}
    if keys.dtype == torch.int8:
        ks = absmax_scale(key_flat)
        vs = absmax_scale(value_flat, dim=(1, 2))                      # (No,)
        key_flat, value_flat = quantize(key_flat, ks), quantize(value_flat, vs[:, None, None])
        k_scale, v_scale = state.k_scale.clone(), state.v_scale.clone()
        k_scale[pos] = ks
        v_scale[:, pos] = vs
        changes = dict(k_scale=k_scale, v_scale=v_scale)
    keys[pos] = key_flat.to(keys.dtype)
    values[:, pos] = value_flat.to(values.dtype)
    valid[pos] = True
    return state._replace(keys=keys, values=values, valid=valid, write_pos=(pos + 1) % keys.shape[0], **changes)


def engaged(state: MemoryState) -> bool:
    return bool(state.valid.any())
