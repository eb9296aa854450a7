"""Memory-attention readout: hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``yolo_puncture_tpu/ops/pallas/mem_attention.py`` (``_kernel`` /
``memory_readout_pallas``).  For every query row it takes the softmax over the
memory of ``q · kᵀ · Ck^-0.5`` with invalid elements masked out, and reads the
per-object values with those weights:

    out[o, q, :] = Σ_m softmax_m(q · k_m · Ck^-0.5 | valid_m) · values[o, m, :]

A row with no valid element gives exact zeros (the denominator is floored at
1e-9).  Inputs are fp32 or bf16 (all three the same); logits, running max, sum
and accumulators are fp32; the output has the values' type.

The kernel lives in ``csrc/memory_readout.cu``; its header states the bound
and the design (online softmax, one block per 64 queries and object, tiles
with no valid element skipped).  On a CPU tensor the wrapper runs
``memory_readout_reference``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from yolo_puncture_tpu_torch import _build

KERNEL_KEY_DIM, KERNEL_VALUE_DIM = 64, 128  # the published widths the kernel is compiled for


def memory_readout_reference(query_key, mem_keys, mem_values, mem_valid) -> torch.Tensor:
    """Plain PyTorch version: masked full softmax in fp32, two matmuls.
    query_key (Q, Ck); mem_keys (M, Ck); mem_values (No, M, Cv); mem_valid (M,)
    bool → (No, Q, Cv) in the values' type."""
    scale = query_key.shape[-1] ** -0.5
    aff = torch.matmul(query_key.float(), mem_keys.float().T) * scale      # (Q, M)
    valid = mem_valid.bool()[None, :]
    aff = aff.masked_fill(~valid, float("-inf"))
    m = aff.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))              # all-invalid rows
    p = torch.exp(aff - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.matmul(p, mem_values.float()) / denom[None]                 # (No, Q, Cv)
    return out.to(mem_values.dtype)


@lru_cache(maxsize=None)
def kernel_fn():
    """The C entry point ``memory_readout`` (built on first use), argtypes set."""
    fn = _build.load("memory_readout").memory_readout
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_args(query_key, mem_keys, mem_values, mem_valid, out):
    """Arguments of ``kernel_fn()`` for checked tensors, on the current stream."""
    Q, Ck = query_key.shape
    No, M, Cv = mem_values.shape
    return (
        query_key.data_ptr(), mem_keys.data_ptr(), mem_values.data_ptr(), mem_valid.data_ptr(),
        out.data_ptr(), Q, M, No, Ck, Cv, int(query_key.dtype == torch.bfloat16),
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


def memory_readout(query_key, mem_keys, mem_values, mem_valid) -> torch.Tensor:
    """query_key (Q, Ck); mem_keys (M, Ck); mem_values (No, M, Cv); mem_valid
    (M,) bool → readout (No, Q, Cv) in the values' type.

    CPU tensors take the plain version; CUDA tensors launch the kernel (fp32 or
    bf16, all contiguous, Ck == 64, Cv == 128) and anything else raises."""
    _check(query_key, mem_keys, mem_values, mem_valid)
    if query_key.device.type == "cpu":
        return memory_readout_reference(query_key, mem_keys, mem_values, mem_valid)
    if query_key.device.type != "cuda":
        raise ValueError(f"memory_readout runs on cpu or cuda, not {query_key.device}")
    dtype = mem_values.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"memory_readout kernel takes fp32 or bf16, got {dtype}")
    for name, t in (("query", query_key), ("keys", mem_keys), ("values", mem_values), ("valid", mem_valid)):
        if name != "valid" and t.dtype != dtype:
            raise TypeError(f"memory_readout kernel takes one type: {name} is {t.dtype}, values {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"memory_readout kernel takes contiguous {name}")
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
    with torch.cuda.device(query_key.device):
        rc = kernel_fn()(*kernel_args(query_key, mem_keys, mem_values, mem_valid, out))
    if rc != 0:
        raise RuntimeError(f"memory_readout kernel launch failed: {_build.error_string('memory_readout', rc)}")
    memory_readout.launches += 1
    return out


memory_readout.launches = 0  # kernel launches since the last reset
