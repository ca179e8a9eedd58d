"""Causal / windowed GQA prefill attention with an online softmax.

Port of the Pallas ``flash_attention`` (repro/kernels/flash_attention.py):
scale ``D**-0.5``, mask -1e30, f32 softmax statistics, probabilities rounded
to the V dtype before PV, fully masked KV tiles skipped; ``window <= 0``
means unbounded. The port reads the serving engine's layout: q ``[B,S,H,D]``,
k/v ``[B,S,Hkv,D]`` (any strides with a contiguous last dimension), output
``[B,S,H,D]``.

``flash_attention_chunk`` is the chunked-prefill form the batched engine
runs: C queries at absolute positions ``q_start..q_start+C-1`` over a
request's KV row of W slots, masked by the slots' positions (``slot_pos``,
-1 = empty) as the reference ``attention(q_pos, k_pos=slot_pos)`` masks
them; it has no Pallas counterpart (the Pallas kernel takes no query
offset), the JAX engine runs XLA ``attention`` there.

On a CUDA tensor each wrapper launches ``csrc/flash_attention.cu`` (wgmma
and TMA, for Hopper; the chunk form is a second entry point of the same
device code); on a CPU tensor it runs its plain version.
``flash_attention.launches`` and ``flash_attention_chunk.launches`` count
kernel launches.
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
# q, k, v, slot_pos, o, B, C, W, H, Hkv, D, strides, spb, q_start, window,
# scale, stream
_CHUNK_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


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


def _check_qkv(q, k, v):
    """What the kernel's tensor maps take: bf16 on one device, head_dim 64
    or 128, a contiguous last dim, 16-byte strides and pointers."""
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head_dim {q.shape[-1]}: the kernel is built for 64 and 128")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError("q, k, v must be bf16 on one device")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("need a contiguous last dim and 16-byte strides")


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
    _check_qkv(q, k, v)
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


def flash_attention_chunk_plain(q, k, v, slot_pos, q_start: int, *,
                                window: int = -1):
    """Plain PyTorch version: one softmax over all W slots, the kernel's
    arithmetic (unnormalised p rounded to bf16, divided by the f32 sum)."""
    B, C, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, C, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    qp = (q_start + torch.arange(C, device=q.device))[None, :, None]
    kp = slot_pos.long()[:, None, :]
    ok = (kp >= 0) & (kp <= qp)
    if window > 0:
        ok &= kp > qp - window
    s = s.masked_fill(~ok[:, None, None], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-20)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)


def flash_attention_chunk(q, k, v, slot_pos, q_start: int, *, window: int = -1):
    """q: [B,C,H,D] at positions q_start..q_start+C-1; k, v: [B,W,Hkv,D]
    (a view of a slot pool is fine); slot_pos: [B,W] int32, -1 = empty
    -> [B,C,H,D]. The kernel scans slots below q_start + C only: prefill
    never wraps the ring (q_start + C <= W, slot j holds position j or -1),
    the caller's invariant."""
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda or slot_pos.is_cuda:
            raise ValueError("flash_attention_chunk: mixed CPU/CUDA tensors")
        return flash_attention_chunk_plain(q, k, v, slot_pos, q_start, window=window)
    B, C, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, W, Hkv, D) or v.shape != k.shape or H % Hkv
            or slot_pos.shape != (B, W) or C < 1):
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} slot_pos {tuple(slot_pos.shape)}")
    if not 0 <= q_start <= W - C:
        raise ValueError(f"chunk at {q_start} of {C} queries past the {W} slots")
    _check_qkv(q, k, v)
    if slot_pos.device != q.device or slot_pos.dtype != torch.int32:
        raise ValueError("slot_pos must be int32 on q's device")
    if (slot_pos.stride(1) != 1 or slot_pos.data_ptr() % 16
            or (B > 1 and (slot_pos.stride(0) % 4 or slot_pos.stride(0) < W))):
        # the kernel's tensor map wants whole 16-byte aligned rows: a copy
        sp = torch.empty((B, -(-W // 4) * 4), dtype=torch.int32, device=q.device)
        sp[:, :W] = slot_pos
        slot_pos = sp[:, :W]
    o = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = _build.function("flash_attention", "flash_attention_chunk_fwd",
                         _CHUNK_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
            o.data_ptr(), B, C, W, H, Hkv, D, strides, slot_pos.stride(0),
            int(q_start), int(window), D ** -0.5, _build.stream_ptr(q))
    _build.check(_build.load("flash_attention"), rc, "flash_attention_chunk")
    flash_attention_chunk.launches += 1
    return o


flash_attention_chunk.launches = 0
