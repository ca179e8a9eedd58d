"""Causal / windowed GQA prefill attention with an online softmax.

Port of the Pallas ``flash_attention`` (repro/kernels/flash_attention.py):
scale ``D**-0.5``, mask -1e30, f32 softmax statistics, probabilities rounded
to the V dtype before PV, fully masked KV tiles skipped; ``window <= 0``
means unbounded. The port reads the serving engine's layout: q ``[B,S,H,D]``,
k/v ``[B,S,Hkv,D]`` (any strides with a contiguous last dimension), output
``[B,S,H,D]``.

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` (wgmma
and TMA, for Hopper); on a CPU tensor it runs ``flash_attention_plain``.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# q, k, v, o, B, S, H, Hkv, D, strides, causal, window, scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = -1):
    """Plain PyTorch version: one softmax over all keys, the kernel's
    arithmetic (unnormalised p rounded to bf16, divided by the f32 sum)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-20)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """q: [B,S,H,D]; k, v: [B,S,Hkv,D] -> [B,S,H,D]."""
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention: mixed CPU/CUDA tensors")
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel is built for 64 and 128")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError("q, k, v must be bf16 on one device")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("need a contiguous last dim and 16-byte strides")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, Hkv, D, strides, int(causal), int(window), D ** -0.5,
            _build.stream_ptr(q))
    _build.check(_build.load("flash_attention"), rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
