"""Grouped SwiGLU expert FFN off the expert-cache slot pools.

Port of the Pallas ``expert_ffn`` / ``expert_ffn_from_pool``
(repro/kernels/expert_ffn.py). For each group u with pool slot
``s = slots[u]``::

    out[u] = (silu(x[u] @ w1[s]) * (x[u] @ w3[s])).bf16 @ w2[s]

f32 accumulation, ``h`` rounded to bf16 before the down projection, output
in ``x.dtype``. On a CUDA tensor the wrapper launches the hand-written
kernel (``csrc/expert_ffn.cu``: two wgmma + TMA passes, up and down, that
read each slab in place through a tensor map per pool with the slot as a
coordinate, no gather copy); on a CPU tensor it runs
``expert_ffn_from_pool_plain``, the same function in plain PyTorch.
``expert_ffn_from_pool.launches`` counts calls that launched the kernel,
one per call whatever the number of kernels in it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# x, w1_pool, w3_pool, w2_pool, slots, h, out; U, C, d, f, capacity; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def expert_ffn_plain(x, w1, w3, w2):
    """x: [E,C,d]; w1/w3: [E,d,f]; w2: [E,f,d] -> [E,C,d] (x.dtype)."""
    h = F.silu(torch.matmul(x.float(), w1.float())) \
        * torch.matmul(x.float(), w3.float())
    return torch.matmul(h.to(x.dtype).float(), w2.float()).to(x.dtype)


def expert_ffn_from_pool_plain(x, w1_pool, w3_pool, w2_pool, slots):
    idx = slots.long()
    return expert_ffn_plain(x, w1_pool[idx], w3_pool[idx], w2_pool[idx])


def _check(x, w1_pool, w3_pool, w2_pool, slots):
    U, C, d = x.shape
    cap, d1, f = w1_pool.shape
    if (d1 != d or w3_pool.shape != w1_pool.shape
            or w2_pool.shape != (cap, f, d) or slots.shape != (U,)):
        raise ValueError(f"shapes: x {tuple(x.shape)} w1 {tuple(w1_pool.shape)} "
                         f"w3 {tuple(w3_pool.shape)} w2 {tuple(w2_pool.shape)} "
                         f"slots {tuple(slots.shape)}")
    for t in (x, w1_pool, w3_pool, w2_pool):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("x and the pools must be contiguous, 16-byte aligned bf16")
    if slots.dtype != torch.int32:
        raise ValueError("slots must be int32")
    if d % 128 or f % 64:
        raise ValueError(f"the kernel tiles need d % 128 == 0 and f % 64 == 0 "
                         f"(got d={d}, f={f})")


def expert_ffn_from_pool(x, w1_pool, w3_pool, w2_pool, slots):
    """x: [U,C,d]; w1/w3_pool: [cap,d,f]; w2_pool: [cap,f,d]; slots: [U]
    int32 pool slot per group -> [U,C,d] in x.dtype."""
    tensors = (x, w1_pool, w3_pool, w2_pool, slots)
    if not x.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("expert_ffn_from_pool: mixed CPU/CUDA tensors")
        return expert_ffn_from_pool_plain(*tensors)
    if any(t.device != x.device for t in tensors):
        raise ValueError("expert_ffn_from_pool: tensors on different devices")
    _check(*tensors)
    U, C, d = x.shape
    f = w1_pool.shape[2]
    h = torch.empty((U, C, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _build.function("expert_ffn", "expert_ffn_from_pool", _ARGTYPES)
    rc = fn(x.data_ptr(), w1_pool.data_ptr(), w3_pool.data_ptr(),
            w2_pool.data_ptr(), slots.data_ptr(), h.data_ptr(), out.data_ptr(),
            U, C, d, f, w1_pool.shape[0], _build.stream_ptr(x))
    _build.check(_build.load("expert_ffn"), rc, "expert_ffn_from_pool")
    expert_ffn_from_pool.launches += 1
    return out


expert_ffn_from_pool.launches = 0
