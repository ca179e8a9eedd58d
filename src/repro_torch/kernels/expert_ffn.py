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

``expert_ffn(x, w1, w3, w2)`` is the Pallas ``expert_ffn`` itself: group e
reads slab e (the same kernel with slots 0..E-1), as the capacity-dispatch
``moe_ffn`` runs it on its [E, C, d] buffer; ``expert_ffn.launches`` counts
its calls. ``ExpertFFNFn`` gives it a gradient: the forward is
``expert_ffn``, the backward recomputes ``x @ w1`` and ``x @ w3`` and gives
dx, dw1, dw3 and dw2 by ``torch.bmm`` (the reference differentiates its
einsums in XLA; the Pallas kernel has no backward).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.models.layers import matmul_rows

PLAIN_CHUNK_ELEMS = 1 << 30   # f32 entries the plain version copies at once
# x, w1_pool, w3_pool, w2_pool, slots, h, out; U, C, d, f, capacity; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def expert_ffn_plain(x, w1, w3, w2):
    """x: [E,C,d]; w1/w3: [E,d,f]; w2: [E,f,d] -> [E,C,d] (x.dtype). Each
    expert is its own function: where the f32 copies of all experts' rows
    and slabs would pass ``PLAIN_CHUNK_ELEMS`` entries (Kimi-K2's 384 slabs
    alone are 17 G), the experts go in chunks of that many."""
    E, C, d = x.shape
    n = max(1, PLAIN_CHUNK_ELEMS // (C * d + 3 * w1.shape[1] * w1.shape[2]))
    if n >= E:
        return _plain_experts(x, w1, w3, w2)
    out = torch.empty_like(x)
    for i in range(0, E, n):
        out[i:i + n] = _plain_experts(x[i:i + n], w1[i:i + n], w3[i:i + n], w2[i:i + n])
    return out


def _plain_experts(x, w1, w3, w2):
    xf = x.float()
    h = F.silu(matmul_rows(xf, w1.float())) * matmul_rows(xf, w3.float())
    return matmul_rows(h.to(x.dtype).float(), w2.float()).to(x.dtype)


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


def _launch(x, w1_pool, w3_pool, w2_pool, slots):
    _check(x, w1_pool, w3_pool, w2_pool, slots)
    _build.refuse_grad("expert_ffn (use ExpertFFNFn)", x, w1_pool, w3_pool, w2_pool)
    U, C, d = x.shape
    f = w1_pool.shape[2]
    h = torch.empty((U, C, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _build.function("expert_ffn", "expert_ffn_from_pool", _ARGTYPES)
    rc = fn(x.data_ptr(), w1_pool.data_ptr(), w3_pool.data_ptr(),
            w2_pool.data_ptr(), slots.data_ptr(), h.data_ptr(), out.data_ptr(),
            U, C, d, f, w1_pool.shape[0], _build.stream_ptr(x))
    _build.check(_build.load("expert_ffn"), rc, "expert_ffn")
    return out


def expert_ffn(x, w1, w3, w2):
    """x: [E,C,d]; w1/w3: [E,d,f]; w2: [E,f,d] -> [E,C,d] in x.dtype."""
    if not x.is_cuda:
        if any(t.is_cuda for t in (w1, w3, w2)):
            raise ValueError("expert_ffn: mixed CPU/CUDA tensors")
        return expert_ffn_plain(x, w1, w3, w2)
    if any(t.device != x.device for t in (w1, w3, w2)):
        raise ValueError("expert_ffn: tensors on different devices")
    slots = torch.arange(w1.shape[0], dtype=torch.int32, device=x.device)
    out = _launch(x, w1, w3, w2, slots)
    expert_ffn.launches += 1
    return out


expert_ffn.launches = 0


class ExpertFFNFn(torch.autograd.Function):
    """``expert_ffn`` with a gradient. The backward recomputes the up
    projections and runs its seven products as ``torch.bmm`` in the
    operands' dtype (f32 sums; on bf16 tensors the tensor cores), the
    elementwise SiLU terms in f32, and gives each gradient in its input's
    dtype. ``apply(x, w1, w3, w2)``."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        ctx.save_for_backward(x, w1, w3, w2)
        return expert_ffn(x, w1, w3, w2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w3, w2 = ctx.saved_tensors
        dt = x.dtype
        dy = dy.to(dt)
        a = torch.bmm(x, w1).float()                 # gate pre-activation
        b = torch.bmm(x, w3).float()                 # up projection
        sig = torch.sigmoid(a)
        h = (a * sig * b).to(dt)
        dh = torch.bmm(dy, w2.transpose(1, 2)).float()
        da = (dh * b * sig * (1 + a * (1 - sig))).to(dt)
        db = (dh * a * sig).to(dt)
        dx = torch.bmm(da, w1.transpose(1, 2)) + torch.bmm(db, w3.transpose(1, 2))
        xt = x.transpose(1, 2)
        return (dx.to(dt), torch.bmm(xt, da).to(w1.dtype), torch.bmm(xt, db).to(w3.dtype),
                torch.bmm(h.transpose(1, 2), dy).to(w2.dtype))


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
    out = _launch(*tensors)
    expert_ffn_from_pool.launches += 1
    return out


expert_ffn_from_pool.launches = 0
