"""The mask tracker's streaming step in plain fp32 PyTorch (DEVA-style, NCHW).

One step takes B frames: it resizes them as ``jax.image.resize(..., "bilinear")``
does (an antialiased triangle when shrinking), encodes every frame's key and
skips, then walks windows of ``window`` frames.  Each window reads the memory
once for all its frames (a full softmax over every valid memory element), runs
the decoder head and the sensory GRU frame by frame, and, when any object is
active, writes the ring from its last frame: first, with long-term memory on
and the target ring slot filled, the slot's most used elements move to the
long-term bank.  Afterwards the decode tail (nearest ×2 → 3×3 conv → + skip,
twice, then a 1×1 head) runs on every frame and object, the stride-4 logits are
upsampled bilinearly to the tracker's resolution, the objects and the
background are soft-aggregated and the argmax is the id map.

``TrackerState`` holds the memory as plain tensors; ``valid`` is also kept as a
list on the host (it follows from the write schedule), so the step never reads
the device to steer itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.blocks import C2f, ConvBN, Block, conv1x1
from benchmark.reference.numerics import Numerics
from benchmark.reference.yolo import half_pixel_matrix

KEY_DIM, VALUE_DIM, SENSORY_DIM = 64, 128, 64


def space_to_depth(x, r=4):
    """(B, C, H, W) → (B, C·r², H/r, W/r), channel (r_h·r + r_w)·C + c."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, C * r * r, H // r, W // r)


class KeyEncoder(Block):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(48, 128, 3)
        self.stage1 = C2f(128, 128, 1, True)
        self.down2 = ConvBN(128, 256, 3, 2)
        self.stage2 = C2f(256, 256, 1, True)
        self.down3 = ConvBN(256, 256, 3, 2)
        self.stage3 = C2f(256, 256, 1, True)
        self.key_proj = ConvBN(256, KEY_DIM, 1, act=False)

    def forward(self, x):
        f4 = self.stage1(self.stem(space_to_depth(x, 4)))
        f8 = self.stage2(self.down2(f4))
        f16 = self.stage3(self.down3(f8))
        return self.key_proj(f16), f4, f8, f16


class ValueEncoder(Block):
    def __init__(self):
        super().__init__()
        self.fuse1 = ConvBN(256 + 1 + SENSORY_DIM, 256, 3)
        self.block = C2f(256, 256, 1, True)
        self.value_proj = ConvBN(256, VALUE_DIM, 1, act=False)

    def forward(self, f16, mask_s16, sensory):
        """f16 (C, h, w); mask_s16 (No, 1, h, w); sensory (No, Cs, h, w) → (No, Cv, h, w)."""
        x = torch.cat([f16[None].expand(mask_s16.shape[0], -1, -1, -1), mask_s16, sensory], 1)
        return self.value_proj(self.block(self.fuse1(x)))


class SensoryUpdater(Block):
    def __init__(self):
        super().__init__()
        self.gates = ConvBN(SENSORY_DIM + 128, 2 * SENSORY_DIM, 3, act=False)
        self.cand = ConvBN(SENSORY_DIM + 128, SENSORY_DIM, 3, act=False)

    def forward(self, sensory, feat):
        gates = self.gates(torch.cat([sensory, feat], 1))
        z, r = torch.sigmoid(gates[:, :SENSORY_DIM]), torch.sigmoid(gates[:, SENSORY_DIM:])
        cand = torch.tanh(self.cand(torch.cat([r * sensory, feat], 1)))
        return (1 - z) * sensory + z * cand


class MaskDecoder(Block):
    def __init__(self):
        super().__init__()
        self.skip8 = ConvBN(256, 64, 1)
        self.skip4 = ConvBN(128, 64, 1)
        self.in_conv = ConvBN(VALUE_DIM + SENSORY_DIM, 128, 3)
        self.dec8 = ConvBN(128, 64, 3)
        self.dec4 = ConvBN(64, 64, 3)
        self.out = nn.Conv2d(64, 1, 1)
        self.out16 = nn.Conv2d(128, 1, 1)

    def head(self, readout, sensory):
        hidden = self.in_conv(torch.cat([readout, sensory], 1))
        return hidden, conv1x1(self.num, self.out16, hidden)[:, 0]

    def tail(self, hidden, f8p, f4p):
        """hidden (No, C, h, w); f8p (Cd, 2h, 2w); f4p (Cd, 4h, 4w) → stride-4 logits (No, 4h, 4w)."""
        x = self.dec8(F.interpolate(hidden, scale_factor=2, mode="nearest")) + f8p[None]
        x = self.dec4(F.interpolate(x, scale_factor=2, mode="nearest")) + f4p[None]
        return conv1x1(self.num, self.out, x)[:, 0]


class TrackerNet(Block):
    """The tracker's network; names follow the flax module paths."""

    def __init__(self):
        super().__init__()
        self.key_encoder = KeyEncoder()
        self.value_encoder = ValueEncoder()
        self.sensory = SensoryUpdater()
        self.decoder = MaskDecoder()


@dataclasses.dataclass
class TrackerState:
    keys: torch.Tensor       # (T, HW, Ck) ring
    values: torch.Tensor     # (No, T, HW, Cv)
    valid: List[bool]        # (T,) ring slot filled
    write_pos: int
    usage: torch.Tensor      # (T, HW) accumulated attention mass
    lt_keys: torch.Tensor    # (P, Ck) long-term bank
    lt_values: torch.Tensor  # (No, P, Cv)
    lt_valid: torch.Tensor   # (P,) bool
    lt_pos: int
    sensory: torch.Tensor    # (No, Cs, h16, w16)
    active: torch.Tensor     # (No,) bool
    frame_idx: int


def initial_state(h16, w16, max_objects, mem_frames, lt_capacity, device) -> TrackerState:
    """An empty memory with object slot 0 active."""
    z = lambda *s: torch.zeros(s, device=device)   # noqa: E731
    active = torch.zeros(max_objects, dtype=torch.bool, device=device)
    active[0] = True
    return TrackerState(z(mem_frames, h16 * w16, KEY_DIM), z(max_objects, mem_frames, h16 * w16, VALUE_DIM),
                        [False] * mem_frames, 0, z(mem_frames, h16 * w16), z(lt_capacity, KEY_DIM),
                        z(max_objects, lt_capacity, VALUE_DIM),
                        torch.zeros(lt_capacity, dtype=torch.bool, device=device), 0,
                        z(max_objects, SENSORY_DIM, h16, w16), active, 0)


def antialiased_matrix(src: int, dst: int, device) -> torch.Tensor:
    """(src, dst) weights of ``jax.image.resize(..., "bilinear")`` along one axis:
    a triangle kernel widened by src/dst when shrinking, columns normalised."""
    inv = src / dst
    width = max(inv, 1.0)
    sample = (np.arange(dst) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(src)[:, None]) / width
    w = np.clip(1.0 - x, 0.0, None)
    w = w / w.sum(axis=0, keepdims=True)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def resize_frames(frames_u8: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) → (B, 3, h, w) fp32 in [0, 1], channel order kept."""
    B, H, W, _ = frames_u8.shape
    x = frames_u8.permute(0, 3, 1, 2).float()
    x = torch.matmul(antialiased_matrix(H, hw[0], x.device).T, torch.matmul(x, antialiased_matrix(W, hw[1], x.device)))
    return x / 255.0


def soft_aggregate(logits, active, eps=1e-7):
    """(…, No, H, W) object logits → (…, No+1, H, W) probabilities, background
    Π(1 − pᵢ) over the active objects."""
    p = torch.sigmoid(logits) * active.float()[:, None, None]
    bg = torch.clamp(torch.prod(1.0 - p, dim=-3, keepdim=True), eps, 1.0)
    stack = torch.cat([torch.log(bg / (1 - bg + eps) + eps), torch.log(p / (1 - p + eps) + eps)], -3)
    return torch.softmax(stack, dim=-3)


def readout(num: Numerics, q, keys, values, valid):
    """Full softmax of q·kᵀ·Ck^-0.5 over the valid memory elements, then the
    per-object values.  q (Q, Ck); keys (M, Ck); values (No, M, Cv); valid (M,)
    → readout (No, Q, Cv) and the attention mass per element (M,).  A row with
    no valid element reads zeros."""
    s = num.matmul(q, keys.T) * q.shape[1] ** -0.5
    s = s.masked_fill(~valid[None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m) * valid[None, :]
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return num.matmul(p, values), p.sum(dim=0)


class Tracker:
    """The step of ``build_bench_tracker`` for one configuration: geometry
    (h, w), ``window`` frames a window (the ring written every window),
    ``full_res_ids``, long-term memory on or off."""

    def __init__(self, net: TrackerNet, hw: Tuple[int, int], window: int, long_term: bool,
                 num_prototypes: int = 128, full_res_ids: bool = True):
        self.net, self.hw, self.window, self.long_term = net, hw, window, long_term
        self.h16, self.w16 = hw[0] // 16, hw[1] // 16
        self.num_prototypes = min(num_prototypes, self.h16 * self.w16)
        self.full_res_ids = full_res_ids

    def _bank(self, st: TrackerState):
        T, HW = st.keys.shape[:2]
        keys = torch.cat([st.keys.reshape(T * HW, -1), st.lt_keys], 0)
        vals = torch.cat([st.values.reshape(st.values.shape[0], T * HW, -1), st.lt_values], 1)
        ring_valid = torch.tensor(st.valid, device=keys.device).repeat_interleave(HW)
        return keys, vals, torch.cat([ring_valid, st.lt_valid])

    def _consolidate(self, st: TrackerState) -> TrackerState:
        """The slot about to be overwritten: its ``num_prototypes`` most used
        elements (ties to the lower index) join the long-term bank, first in,
        first out; the slot is freed."""
        o, n = st.write_pos, self.num_prototypes
        idx = torch.sort(st.usage[o], descending=True, stable=True).indices[:n]
        P = st.lt_keys.shape[0]
        slots = (st.lt_pos + torch.arange(n, device=idx.device)) % P
        lt_keys, lt_values, lt_valid = st.lt_keys.clone(), st.lt_values.clone(), st.lt_valid.clone()
        lt_keys[slots] = st.keys[o][idx]
        lt_values[:, slots] = st.values[:, o][:, idx]
        lt_valid[slots] = True
        usage, valid = st.usage.clone(), list(st.valid)
        usage[o] = 0.0
        valid[o] = False
        return dataclasses.replace(st, lt_keys=lt_keys, lt_values=lt_values, lt_valid=lt_valid,
                                   lt_pos=(st.lt_pos + n) % P, usage=usage, valid=valid)

    def _write(self, st: TrackerState, key, f16, fg16) -> TrackerState:
        value = self.net.value_encoder(f16, fg16[:, None], st.sensory)
        pos = st.write_pos
        keys, values, valid = st.keys.clone(), st.values.clone(), list(st.valid)
        keys[pos] = key.flatten(1).T
        values[:, pos] = value.flatten(2).transpose(1, 2)
        valid[pos] = True
        return dataclasses.replace(st, keys=keys, values=values, valid=valid, write_pos=(pos + 1) % len(valid))

    def _window(self, st: TrackerState, keys_w, f16_w, any_active: bool):
        """One window: (state, hidden (w, No, C, h16, w16))."""
        w = keys_w.shape[0]
        bank_k, bank_v, bank_ok = self._bank(st)
        q = keys_w.flatten(2).transpose(1, 2).reshape(w * self.h16 * self.w16, -1)
        r, mass = readout(self.net.num, q, bank_k, bank_v, bank_ok)
        if self.long_term:
            T, HW = st.keys.shape[:2]
            st = dataclasses.replace(st, usage=st.usage + mass[:T * HW].reshape(T, HW))
        r = r.reshape(r.shape[0], w, self.h16, self.w16, -1).permute(1, 0, 4, 2, 3)
        sensory, hiddens = st.sensory, []
        for i in range(w):
            hidden, logits16 = self.net.decoder.head(r[i], sensory)
            sensory = self.net.sensory(sensory, hidden)
            hiddens.append(hidden)
        fg16 = soft_aggregate(logits16, st.active)[1:]
        st = dataclasses.replace(st, sensory=sensory)
        if any_active:
            if self.long_term and st.valid[st.write_pos]:
                st = self._consolidate(st)
            st = self._write(st, keys_w[-1], f16_w[-1], fg16)
        return dataclasses.replace(st, frame_idx=st.frame_idx + w), torch.stack(hiddens)

    @torch.no_grad()
    def propagate(self, st: TrackerState, frames_u8: torch.Tensor, any_active: bool = True, block: int = 16):
        """The memory-coupled part of a step: (state after the frames, hidden
        states (B, No, C, h16, w16), skips f4 and f8)."""
        B = frames_u8.shape[0]
        enc = self.net.key_encoder
        keys, f4, f8, f16 = (torch.cat(t) for t in zip(*(enc(resize_frames(frames_u8[i:i + block], self.hw))
                                                          for i in range(0, B, block))))
        hiddens = []
        for i in range(0, B, self.window):
            st, hidden = self._window(st, keys[i:i + self.window], f16[i:i + self.window], any_active)
            hiddens.append(hidden)
        return st, torch.cat(hiddens), f4, f8

    @torch.no_grad()
    def step(self, st: TrackerState, frames_u8: torch.Tensor, any_active: bool = True, block: int = 16):
        """B frames (B, H, W, 3) uint8 → (state after them, ids (B, h, w) uint8,
        or (B, h/4, w/4) without ``full_res_ids``).  The encoder and the tail run
        in blocks of ``block`` frames; the windows one after another."""
        B = frames_u8.shape[0]
        st, hidden, f4, f8 = self.propagate(st, frames_u8, any_active, block)
        dec = self.net.decoder
        ids = []
        for i in range(B):
            logits = dec.tail(hidden[i], dec.skip8(f8[i:i + 1])[0], dec.skip4(f4[i:i + 1])[0])
            if self.full_res_ids:
                h4, w4 = logits.shape[-2:]
                logits = torch.matmul(half_pixel_matrix(h4, 4 * h4, logits.device).T,
                                      torch.matmul(logits, half_pixel_matrix(w4, 4 * w4, logits.device)))
            ids.append(soft_aggregate(logits, st.active).argmax(dim=0).to(torch.uint8))
        return st, torch.stack(ids)


def state_from(mem, device=None) -> TrackerState:
    """A ``TrackerState`` in fp32 from any object with the memory's fields (the
    program's memory after a step): its values, read as they are."""
    f = lambda t: t.detach().to(device or t.device, torch.float32).clone()   # noqa: E731
    return TrackerState(f(mem.keys), f(mem.values), [bool(v) for v in mem.valid.tolist()], int(mem.write_pos),
                        f(mem.usage), f(mem.lt_keys), f(mem.lt_values), mem.lt_valid.detach().to(device or mem.lt_valid.device).clone(),
                        int(mem.lt_pos), f(mem.sensory), mem.active.detach().to(device or mem.active.device).clone(),
                        int(mem.frame_idx))


def state_gap(ref: TrackerState, other: TrackerState, fields=("keys", "values", "sensory")) -> float:
    """The widest relative Frobenius distance over the state's float tensors."""
    gaps = []
    for name in fields:
        a, b = getattr(ref, name).float(), getattr(other, name).float().to(getattr(ref, name).device)
        gaps.append(float((a - b).norm() / a.norm().clamp_min(1e-12)))
    if ref.valid != other.valid or ref.write_pos != other.write_pos:
        gaps.append(1.0)
    return max(gaps)


