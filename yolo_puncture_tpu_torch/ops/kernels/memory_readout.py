"""Memory-attention readout: hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``yolo_puncture_tpu/ops/pallas/mem_attention.py`` (``_kernel`` /
``memory_readout_pallas``).  For every query row it takes the softmax over the
memory of ``q · kᵀ · Ck^-0.5`` with invalid elements masked out, and reads the
per-object values with those weights:

    out[o, q, :] = Σ_m softmax_m(q · k_m · Ck^-0.5 | valid_m) · values[o, m, :]

A row with no valid element gives exact zeros (the denominator is floored at
1e-9).  Inputs are fp32 or bf16 (all three the same); logits, running max, sum
and accumulators are fp32; the output has the values' type.

With bf16 inputs the weights are rounded to bf16 before they multiply the values,
while their sum is taken from the fp32 weights: what the TPU kernel does, and
what the tensor cores need.

``affinity_bf16=True`` rounds every logit as the JAX package's dense readout
rounds its (Q, M) affinity (``track/network.py memory_readout_dense``):
``bf16(bf16(q · k) · bf16(Ck^-0.5))``, for fp32 and bf16 inputs alike; the max,
the sum and the accumulators stay fp32.  ``TrackerCore(affinity_bf16=True)``
(the bench's tracker) reads memory so.

The kernel lives in ``csrc/memory_readout.cu``; its header states the bounds
and the design (one block per 128 queries and object pair, the softmax shared
by the pair, tiles with no valid element skipped, ``wgmma`` fed by TMA: bf16 as
it is, fp32 as three error-compensated TF32 products).  Where the query is too short
to fill the card, the memory is split over blocks and a second kernel combines
the splits' partial results; ``memory_readout_partials`` and
``combine_partials`` are the plain version of that.  On a CPU tensor the wrapper
runs ``memory_readout_reference``; on a CUDA tensor it launches the kernel or
raises.

Gradients (training): where grad mode is on and the query, keys or values
require a gradient, the call goes through ``MemoryReadout``, an
``autograd.Function`` whose forward is the same kernel (or plain version) and
whose backward is the gradient of the dense readout that JAX's autodiff of
``track/network.py memory_readout_dense`` gives, from the fp32 weights ``P``
recomputed from the query and the keys (``readout_weights``):

    dV[o] = Pᵀ·dO[o];  dP = Σ_o dO[o]·V[o]ᵀ;  δ = Σ_o rowsum(dO[o] ∘ O[o])
    dS = P ∘ (dP − δ);  dq = dS·k·Ck^-0.5;  dk = dSᵀ·q·Ck^-0.5

Rows with no valid element get zero gradients; ``valid`` gets none.  With
``affinity_bf16`` the cotangent of the logits is rounded where JAX rounds it
(``logit_cotangent_products``).  The products are plain ``torch.matmul``: the
JAX package has no backward kernel either.

bf16 inputs (bf16 training) take the same kernel forward, and a backward that
follows JAX's autodiff of the dense readout on bf16 inputs step by step
(``readout_vjp_bf16``): there the weights are the unnormalised ``bf16(exp(s − m))``,
the denominator their sum (a column of ones beside the values), and the
cotangents of the weights, of the values, of the query and of the keys are
rounded to bf16.  Other types raise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from yolo_puncture_tpu_torch import _build

KERNEL_KEY_DIM, KERNEL_VALUE_DIM = 64, 128  # the published widths the kernel is compiled for
TILE_M, TILE_Q = 64, 128   # memory elements per validity word; query rows per block
MAX_SPLIT = 16             # most blocks that share one query tile's memory


def readout_logits(query_key, mem_keys, affinity_bf16: bool = False) -> torch.Tensor:
    """The readout's fp32 logits (Q, M): ``q · kᵀ · Ck^-0.5``, or with
    ``affinity_bf16`` the product rounded to bf16, times bf16(Ck^-0.5), rounded
    to bf16 again, as ``network.memory_readout_dense`` rounds them."""
    scale = query_key.shape[-1] ** -0.5
    aff = torch.matmul(query_key.float(), mem_keys.float().T)
    if affinity_bf16:
        return (aff.bfloat16() * torch.tensor(scale, dtype=torch.bfloat16)).float()
    return aff * scale


def memory_readout_reference(query_key, mem_keys, mem_values, mem_valid, affinity_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: masked full softmax in fp32, two matmuls.
    query_key (Q, Ck); mem_keys (M, Ck); mem_values (No, M, Cv); mem_valid (M,)
    bool → (No, Q, Cv) in the values' type.  bf16 values are multiplied by
    weights rounded to bf16; the denominator sums the fp32 weights.  The logits
    are ``readout_logits``."""
    aff = readout_logits(query_key, mem_keys, affinity_bf16)                # (Q, M)
    valid = mem_valid.bool()[None, :]
    aff = aff.masked_fill(~valid, float("-inf"))
    m = aff.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))              # all-invalid rows
    p = torch.exp(aff - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if mem_values.dtype == torch.bfloat16:
        p = p.bfloat16().float()
    out = torch.matmul(p, mem_values.float()) / denom[None]                 # (No, Q, Cv)
    return out.to(mem_values.dtype)


def memory_readout_partials(query_key, mem_keys, mem_values, mem_valid, n_split: int):
    """Plain version of what the kernel's blocks write when the memory is split:
    the memory is cut into ``n_split`` runs of whole 64-element tiles, and each
    gives its row max ``m`` (n_split, Q; -inf where it has no valid element), its
    sum ``l`` (n_split, Q) of exp(s - m) and its unnormalised readout ``acc``
    (n_split, No, Q, Cv), all fp32."""
    M = mem_keys.shape[0]
    n_tiles = -(-M // TILE_M)
    per = -(-n_tiles // n_split) * TILE_M
    ms, ls, accs = [], [], []
    for z in range(n_split):
        lo, hi = min(z * per, M), min((z + 1) * per, M)
        valid = mem_valid[lo:hi].bool()[None, :]
        aff = readout_logits(query_key, mem_keys[lo:hi])
        aff = aff.masked_fill(~valid, float("-inf"))
        m = aff.max(dim=-1).values if hi > lo else aff.new_full(aff.shape[:1], float("-inf"))
        shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(aff - shift[:, None]) * valid
        ms.append(m)
        ls.append(p.sum(dim=-1))
        if mem_values.dtype == torch.bfloat16:
            p = p.bfloat16().float()
        accs.append(torch.matmul(p, mem_values[:, lo:hi].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m, l, acc, dtype=torch.float32) -> torch.Tensor:
    """Plain version of the kernel's combine step: partial results over runs of
    the memory (``memory_readout_partials``) → the readout (No, Q, Cv)."""
    m_all = m.max(dim=0).values
    shift = torch.where(torch.isfinite(m_all), m_all, torch.zeros_like(m_all))
    w = torch.exp(m - shift[None])                                          # (n_split, Q); exp(-inf) = 0
    denom = (w * l).sum(dim=0).clamp_min(1e-9)
    return ((w[:, None, :, None] * acc).sum(dim=0) / denom[None, :, None]).to(dtype)


@lru_cache(maxsize=None)
def kernel_fn():
    """The C entry point ``memory_readout`` (built on first use), argtypes set."""
    fn = _build.load("memory_readout").memory_readout
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def split_for(Q: int, M: int, device) -> int:
    """How many blocks share the memory of one query tile: as many as it takes
    for the grid of (query tiles × two object pairs) to fill the card's SMs, so
    for a given memory it follows from Q alone."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms // (2 * -(-Q // TILE_Q)), MAX_SPLIT, -(-M // TILE_M)))


def kernel_scratch(query_key, mem_values, n_split: int):
    """The launch's scratch: one validity word per memory tile; when the memory
    is split, the splits' accumulators, maxima and sums; for fp32, the TF32 high
    and low parts of query, keys and (transposed, in whole tiles) values."""
    Q, Ck = query_key.shape
    No, M, Cv = mem_values.shape
    n_tiles = -(-M // TILE_M)
    words = torch.empty(n_tiles, dtype=torch.int64, device=query_key.device)
    partials = split = None
    if n_split > 1:
        partials = torch.empty(n_split * (No * Q * Cv + 2 * Q), dtype=torch.float32, device=query_key.device)
    if mem_values.dtype == torch.float32:
        split = torch.empty(2 * (Q * Ck + M * Ck + No * Cv * n_tiles * TILE_M), dtype=torch.float32,
                            device=query_key.device)
    return words, partials, split


def kernel_args(query_key, mem_keys, mem_values, mem_valid, out, scratch, n_split: int,
                affinity_bf16: bool = False):
    """Arguments of ``kernel_fn()`` for checked tensors, on the current stream."""
    Q, Ck = query_key.shape
    No, M, Cv = mem_values.shape
    words, partials, split = scratch
    return (
        query_key.data_ptr(), mem_keys.data_ptr(), mem_values.data_ptr(), mem_valid.data_ptr(),
        out.data_ptr(), words.data_ptr(), None if partials is None else partials.data_ptr(),
        None if split is None else split.data_ptr(),
        Q, M, No, Ck, Cv, int(query_key.dtype == torch.bfloat16), int(affinity_bf16), n_split,
        torch.cuda.current_stream(query_key.device).cuda_stream,
    )


def _check(query_key, mem_keys, mem_values, mem_valid):
    if query_key.dim() != 2 or mem_keys.dim() != 2 or mem_values.dim() != 3 or mem_valid.dim() != 1:
        raise ValueError("memory_readout wants query (Q, Ck), keys (M, Ck), values (No, M, Cv), valid (M,)")
    M, Ck = mem_keys.shape
    if query_key.shape[1] != Ck or mem_values.shape[1] != M or mem_valid.shape[0] != M:
        raise ValueError(
            f"shape mismatch: query {tuple(query_key.shape)}, keys {tuple(mem_keys.shape)}, "
            f"values {tuple(mem_values.shape)}, valid {tuple(mem_valid.shape)}"
        )
    if mem_valid.dtype != torch.bool:
        raise TypeError(f"memory_readout takes a bool valid mask, got {mem_valid.dtype}")
    for name, t in (("keys", mem_keys), ("values", mem_values), ("valid", mem_valid)):
        if t.device != query_key.device:
            raise ValueError(f"{name} is on {t.device}, the query on {query_key.device}")


def readout_weights(query_key, mem_keys, mem_valid, affinity_bf16: bool = False) -> torch.Tensor:
    """The readout's fp32 softmax weights P (Q, M) over the valid elements; a
    row with no valid element is all zeros."""
    valid = mem_valid.bool()[None, :]
    aff = readout_logits(query_key, mem_keys, affinity_bf16).masked_fill(~valid, float("-inf"))
    m = aff.max(dim=-1, keepdim=True).values
    p = torch.exp(aff - torch.where(torch.isfinite(m), m, torch.zeros_like(m))) * valid
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def logit_cotangent_products(dS, query_key, mem_keys, affinity_bf16: bool = False):
    """(dq, dk) from the cotangent dS (Q, M) of the scaled logits.  Without
    ``affinity_bf16``: dS·k·Ck^-0.5 and dSᵀ·q·Ck^-0.5 in fp32.  With it, as JAX's
    autodiff takes the two bf16 roundings of the logits back on the CPU: dS is
    rounded to bf16, multiplied by bf16(Ck^-0.5) in bf16, and meets the keys and
    the query rounded to bf16 in products whose results are rounded to bf16."""
    scale = query_key.shape[-1] ** -0.5
    if not affinity_bf16:
        dR = dS * scale
        return dR @ mem_keys.float(), dR.T @ query_key.float()
    dR = (dS.bfloat16() * torch.tensor(scale, dtype=torch.bfloat16)).float()
    kb, qb = mem_keys.bfloat16().float(), query_key.bfloat16().float()
    return (dR @ kb).bfloat16().float(), (dR.T @ qb).bfloat16().float()


def readout_vjp_bf16(query_key, mem_keys, mem_values, mem_valid, d_out, affinity_bf16: bool, needs):
    """(dq, dk, dv) in bf16 for bf16 inputs: the vector-Jacobian product that JAX's
    autodiff takes of ``track/network.py memory_readout_dense`` (no usage), in its
    order.  With e = exp(s − m) masked (fp32), p = bf16(e), l = Σ p and
    O = (p · V) / l:

        dV = bf16(pᵀ · (dO / l));  dl = −Σ dO ∘ (p · V) / l²
        dp = bf16(Σ_o (dO[o] / l) · V[o]ᵀ + dl);  ds = dp ∘ e

    plus the gradient of the row max m: −Σ ds on the row's largest logits (split
    between ties), which is zero but for the roundings of dp.  Then dq = bf16(ds ·
    k · Ck^-0.5) and dk = bf16(dsᵀ · q · Ck^-0.5); with ``affinity_bf16`` the bf16
    logits' cotangent is summed in bf16 and ``logit_cotangent_products`` rounds as
    JAX does.  ``needs`` (``ctx.needs_input_grad`` of the query, keys and values)
    drops dv, or dq and dk, where they are not asked for; a dropped one is None."""
    valid = mem_valid.bool()[None, :]
    aff = readout_logits(query_key, mem_keys, affinity_bf16).masked_fill(~valid, float("-inf"))
    m = aff.max(dim=-1, keepdim=True).values
    finite = torch.isfinite(m)
    e = torch.exp(aff - torch.where(finite, m, torch.zeros_like(m))) * valid          # (Q, M) fp32
    p = e.bfloat16().float()
    l_raw = p.sum(dim=-1)
    l = l_raw.clamp_min(1e-9)
    d_out = d_out.float()
    dv = torch.einsum("qm,nqc->nmc", p, d_out / l[None, :, None]).bfloat16() if needs[2] else None
    if not (needs[0] or needs[1]):
        return None, None, dv
    G = torch.einsum("nqc,nmc->qm", d_out, mem_values.float())                       # Σ_o dO[o]·V[o]ᵀ
    dl = -(p * G).sum(dim=-1) / (l * l) * (l_raw > 1e-9)                               # −Σ dO ∘ (p·V) / l²
    dE = (G / l[:, None] + dl[:, None]).bfloat16().float() * e
    at_max = (aff == m) & finite
    ties = at_max.sum(dim=-1, keepdim=True).clamp_min(1)
    if affinity_bf16:
        dS = (dE.bfloat16() + (-dE.sum(dim=-1, keepdim=True)).bfloat16() / ties.bfloat16() * at_max).float()
    else:
        dS = dE - dE.sum(dim=-1, keepdim=True) / ties * at_max
    dq, dk = logit_cotangent_products(dS * valid, query_key, mem_keys, affinity_bf16)
    return dq.bfloat16(), dk.bfloat16(), dv


class MemoryReadout(torch.autograd.Function):
    """The readout with its gradient: forward the kernel on CUDA tensors (the plain
    version on CPU tensors), backward the dense readout's vector-Jacobian product
    (module docstring), recomputed from the saved query, keys and values."""

    @staticmethod
    def forward(ctx, query_key, mem_keys, mem_values, mem_valid, affinity_bf16):
        out = _readout_forward(query_key, mem_keys, mem_values, mem_valid, affinity_bf16)
        ctx.save_for_backward(query_key, mem_keys, mem_values, mem_valid, out)
        ctx.affinity_bf16 = affinity_bf16
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, valid, out = ctx.saved_tensors
        if v.dtype == torch.bfloat16:
            return (*readout_vjp_bf16(q, k, v, valid, d_out, ctx.affinity_bf16, ctx.needs_input_grad[:3]), None, None)
        P = readout_weights(q, k, valid, ctx.affinity_bf16)                    # (Q, M)
        d_out = d_out.float()
        dv = torch.einsum("qm,nqc->nmc", P, d_out) if ctx.needs_input_grad[2] else None
        dq = dk = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dP = torch.einsum("nqc,nmc->qm", d_out, v.float())
            delta = (d_out * out.float()).sum(dim=(0, 2))                       # (Q,)
            dq, dk = logit_cotangent_products(P * (dP - delta[:, None]), q, k, ctx.affinity_bf16)
        return dq, dk, dv, None, None


def _readout_forward(query_key, mem_keys, mem_values, mem_valid, affinity_bf16: bool):
    if query_key.device.type == "cpu":
        return memory_readout_reference(query_key, mem_keys, mem_values, mem_valid, affinity_bf16)
    return _launch(query_key, mem_keys, mem_values, mem_valid, affinity_bf16)


def memory_readout(query_key, mem_keys, mem_values, mem_valid, affinity_bf16: bool = False) -> torch.Tensor:
    """query_key (Q, Ck); mem_keys (M, Ck); mem_values (No, M, Cv); mem_valid
    (M,) bool → readout (No, Q, Cv) in the values' type; ``affinity_bf16``
    rounds the logits to bf16 (``readout_logits``).

    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32 or
    bf16, all contiguous and 16-byte aligned, Ck == 64, Cv == 128) and anything
    else raises.  ``split_for`` says how many blocks share the memory.  Where
    grad mode is on and an input requires a gradient, the same forward runs
    inside ``MemoryReadout``, which gives the gradients (all three fp32 or all
    three bf16; anything else raises)."""
    _check(query_key, mem_keys, mem_values, mem_valid)
    if query_key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"memory_readout runs on cpu or cuda, not {query_key.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query_key, mem_keys, mem_values)):
        types = {t.dtype for t in (query_key, mem_keys, mem_values)}
        if types not in ({torch.float32}, {torch.bfloat16}):
            raise TypeError(f"memory_readout's gradient takes fp32 or bf16 inputs of one type, got "
                            f"{sorted(map(str, types))}")
        return MemoryReadout.apply(query_key, mem_keys, mem_values, mem_valid, affinity_bf16)
    return _readout_forward(query_key, mem_keys, mem_values, mem_valid, affinity_bf16)


def _launch(query_key, mem_keys, mem_values, mem_valid, affinity_bf16: bool) -> torch.Tensor:
    """The kernel on checked CUDA tensors; counts the launch."""
    dtype = mem_values.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"memory_readout kernel takes fp32 or bf16, got {dtype}")
    for name, t in (("query", query_key), ("keys", mem_keys), ("values", mem_values), ("valid", mem_valid)):
        if name != "valid" and t.dtype != dtype:
            raise TypeError(f"memory_readout kernel takes one type: {name} is {t.dtype}, values {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"memory_readout kernel takes contiguous {name}")
        if name != "valid" and t.data_ptr() % 16:
            raise ValueError(f"memory_readout kernel takes 16-byte aligned {name}")
    Q, Ck = query_key.shape
    No, M, Cv = mem_values.shape
    if Ck != KERNEL_KEY_DIM or Cv != KERNEL_VALUE_DIM:
        raise ValueError(
            f"memory_readout kernel is compiled for Ck == {KERNEL_KEY_DIM} and Cv == {KERNEL_VALUE_DIM}, "
            f"got Ck {Ck}, Cv {Cv}"
        )
    if M == 0:
        return torch.zeros((No, Q, Cv), dtype=dtype, device=query_key.device)
    out = torch.empty((No, Q, Cv), dtype=dtype, device=query_key.device)
    if out.numel() == 0:
        return out
    n_split = split_for(Q, M, query_key.device)
    with torch.cuda.device(query_key.device):
        scratch = kernel_scratch(query_key, mem_values, n_split)
        rc = kernel_fn()(*kernel_args(query_key, mem_keys, mem_values, mem_valid, out, scratch, n_split,
                                      affinity_bf16))
    if rc != 0:
        raise RuntimeError(f"memory_readout kernel launch failed: {_build.error_string('memory_readout', rc)}")
    memory_readout.launches += 1
    return out


memory_readout.launches = 0  # kernel launches since the last reset
