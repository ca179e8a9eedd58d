"""One-token GQA decode attention over a ring-buffer KV cache.

Port of the Pallas ``flash_decode`` (repro/kernels/flash_decode.py), with its
interface generalised to what the engines hold: per-row ``pos [B]`` and
``slot_pos [B,W]`` (the Pallas kernel takes a scalar pos and a shared
``slot_pos [S]``), and caches read in place in the engine's ``[B,W,Hkv,D]``
layout. A slot is valid when ``0 <= slot_pos <= pos`` and, for
``window > 0``, ``slot_pos > pos - window``. Scale ``D**-0.5``, mask -1e30,
f32 softmax statistics, probabilities rounded to the V dtype before PV.

On a CUDA tensor the wrapper launches ``csrc/flash_decode.cu``: a split-K
pass over ``n_splits(...)`` contiguous slot ranges, then a combine pass, both
from one C call; on a CPU tensor it runs ``flash_decode_plain``.
``flash_decode.launches`` counts wrapper calls that launched the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
H100_SMS = 132
MIN_SPLIT_SLOTS = 32    # slots a range holds at least, where W allows
MAX_SPLIT_SLOTS = 64    # the kernel's score buffer (csrc/flash_decode.cu MAX_SPLIT)
# q, k, v, pos, slot_pos, o, scratch, B, H, Hkv, W, D, strides, window,
# scale, n_split, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_SMS = {}


def n_splits(B: int, Hkv: int, W: int, sms: int = H100_SMS) -> int:
    """How many slot ranges the split pass cuts W into: enough blocks
    (B * Hkv * n) to cover ``sms`` SMs, at most ``MAX_SPLIT_SLOTS`` slots a
    range, and at least ``MIN_SPLIT_SLOTS`` where W allows. Range i is
    ``[i*W // n, (i+1)*W // n)``, so lengths differ by at most one."""
    n = max(-(-sms // (B * Hkv)), -(-W // MAX_SPLIT_SLOTS))
    return max(1, min(n, W // MIN_SPLIT_SLOTS))


def flash_decode_plain(q, k, v, pos, slot_pos, *, window: int = -1):
    """Plain PyTorch version: one softmax over all slots, the kernel's
    arithmetic (unnormalised p rounded to bf16, divided by the f32 sum)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s = torch.einsum("bhgd,bwhd->bhgw", q.reshape(B, Hkv, G, D).float(),
                     k.float()) * D ** -0.5
    sp, p_ = slot_pos.long(), pos.long()[:, None]
    ok = (sp >= 0) & (sp <= p_)
    if window > 0:
        ok &= sp > p_ - window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(v.dtype).float(), v.float())
    return (o / torch.clamp(l, min=1e-20)).reshape(B, H, D).to(q.dtype)


def flash_decode(q, k, v, pos, slot_pos, *, window: int = -1):
    """q: [B,H,D]; k, v: [B,W,Hkv,D]; pos: [B] int32; slot_pos: [B,W]
    int32 (a broadcast batch stride of 0 is fine) -> [B,H,D]."""
    tensors = (q, k, v, pos, slot_pos)
    if not q.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("flash_decode: mixed CPU/CUDA tensors")
        return flash_decode_plain(q, k, v, pos, slot_pos, window=window)
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, W, Hkv, D) or v.shape != k.shape or H % Hkv
            or pos.shape != (B,) or slot_pos.shape != (B, W)):
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"pos {tuple(pos.shape)} slot_pos {tuple(slot_pos.shape)}")
    if D not in (64, 128) or H // Hkv > 8:
        raise ValueError(f"the kernel is built for head_dim 64/128 and at most "
                         f"8 query heads per KV head (D={D}, G={H // Hkv})")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: tensors on different devices")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError("q, k, v must be bf16 with a contiguous last dim")
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError("q, k, v need 16-byte strides and pointers")
    if pos.dtype != torch.int32 or slot_pos.dtype != torch.int32 \
            or slot_pos.stride(1) != 1:
        raise ValueError("pos / slot_pos must be int32, slot_pos rows contiguous")
    pos = pos.contiguous()   # the kernel reads pos[b] at stride 1
    if q.device not in _SMS:
        _SMS[q.device] = torch.cuda.get_device_properties(q.device).multi_processor_count
    n = n_splits(B, Hkv, W, _SMS[q.device])
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    scratch = torch.empty(B * H * n * (D + 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        slot_pos.stride(0), o.stride(0), o.stride(1))
    fn = _build.function("flash_decode", "flash_decode_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            slot_pos.data_ptr(), o.data_ptr(), scratch.data_ptr(), B, H, Hkv, W,
            D, strides, int(window), D ** -0.5, n, _build.stream_ptr(q))
    _build.check(_build.load("flash_decode"), rc, "flash_decode")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
