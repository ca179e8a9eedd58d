"""One-token GQA decode attention over a ring-buffer KV cache.

Port of the Pallas ``flash_decode`` (repro/kernels/flash_decode.py), with its
interface generalised to what the engines hold: per-row ``pos [B]`` and
``slot_pos [B,W]`` (the Pallas kernel takes a scalar pos and a shared
``slot_pos [S]``), and caches read in place in the engine's ``[B,W,Hkv,D]``
layout. A slot is valid when ``0 <= slot_pos <= pos`` and, for
``window > 0``, ``slot_pos > pos - window``. Scale ``D**-0.5``, mask -1e30,
f32 softmax statistics, probabilities rounded to the V dtype before PV.

On a CUDA tensor the wrapper launches ``csrc/flash_decode.cu``: a split pass
over ``n_splits(Hkv, W)`` ranges of whole ``TILE_SLOTS``-slot tiles, in which
one block serves every query head of a KV head on the tensor cores, then a
combine pass, both from one C call; on a CPU tensor it runs
``flash_decode_plain``. The ranges do not depend on the batch, so a row's
output is bit-equal alone and in any batch. The kernel takes head_dim 64,
112, 128 and 256 and up to ``MAX_GROUP`` query heads per KV head.
``flash_decode.launches`` counts wrapper calls that launched the kernels.

``return_lse`` adds each head's log-sum-exp of the scaled logits [B,H] f32
(natural log), written by the combine pass; a row with no valid slot gets
``-inf`` and an output of 0 (not the mean of V, whose read of every slot
would cost more than the rest of the call), so its partial takes zero
weight where a mesh merges the ranks' blocks of a slot-sharded ring
(``collectives.lse_combine``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
H100_SMS = 132
TILE_SLOTS = 64         # slots of a tile (csrc/flash_decode.cu TILE)
MAX_RANGE_TILES = 64    # tiles a range holds at most (csrc/flash_decode.cu MAX_TILES)
MAX_GROUP = 64          # query heads a block serves: four 16-row mma tiles
HEAD_DIMS = (64, 112, 128, 256)
# q, k, v, pos, slot_pos, o, lse, scratch, B, H, Hkv, W, D, strides, window,
# scale, n_split, stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_SMS = {}


def n_splits(Hkv: int, W: int, sms: int = H100_SMS) -> int:
    """How many slot ranges the split pass cuts W into, from the KV heads
    and W alone (never the batch): enough blocks (Hkv * n) for two on each
    of ``sms`` SMs at B=1, at least one tile a range and at most
    ``MAX_RANGE_TILES``. Of the T = ceil(W / TILE_SLOTS) tiles, range i
    holds tiles ``[i*T // n, (i+1)*T // n)`` (the last tile ends at W), so
    range lengths differ by at most one tile."""
    T = -(-W // TILE_SLOTS)
    n = max(-(-2 * sms // Hkv), -(-T // MAX_RANGE_TILES))
    return max(1, min(n, T))


def split_plan(B: int, H: int, Hkv: int, W: int, D: int, sms: int = H100_SMS) -> dict:
    """The launch the wrapper makes for a [B,H,D] query over W slots: the
    split count (``n_splits``, the same for every B) and the scratch floats
    (each head's partial acc and (m, l) in each range)."""
    n = n_splits(Hkv, W, sms)
    return dict(n_split=n, scratch=B * H * n * (D + 2))


def flash_decode_plain(q, k, v, pos, slot_pos, *, window: int = -1,
                       return_lse: bool = False):
    """Plain PyTorch version: one softmax over all slots, the kernel's
    arithmetic (unnormalised p rounded to bf16, divided by the f32 sum).
    ``return_lse``: also each head's log-sum-exp [B,H] f32, -inf for a row
    with no valid slot, whose output is then 0."""
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
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(v.dtype).float(), v.float())
    o = (o / torch.clamp(l, min=1e-20)).reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return o
    empty = ~ok.any(-1)[:, None]
    lse = (m + torch.log(l)).reshape(B, H).masked_fill(empty, float("-inf"))
    return o.masked_fill(empty[..., None], 0), lse


def flash_decode(q, k, v, pos, slot_pos, *, window: int = -1, return_lse: bool = False):
    """q: [B,H,D]; k, v: [B,W,Hkv,D]; pos: [B] int32; slot_pos: [B,W]
    int32 (a broadcast batch stride of 0 is fine) -> [B,H,D], and with
    ``return_lse`` also the log-sum-exp [B,H] f32 (module docstring)."""
    tensors = (q, k, v, pos, slot_pos)
    if not q.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("flash_decode: mixed CPU/CUDA tensors")
        return flash_decode_plain(q, k, v, pos, slot_pos, window=window,
                                  return_lse=return_lse)
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, W, Hkv, D) or v.shape != k.shape or H % Hkv
            or pos.shape != (B,) or slot_pos.shape != (B, W)):
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"pos {tuple(pos.shape)} slot_pos {tuple(slot_pos.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head_dim in {HEAD_DIMS} (D={D})")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel serves at most {MAX_GROUP} query heads per KV head "
                         f"(G={H // Hkv})")
    _build.refuse_grad("flash_decode", q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: tensors on different devices")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError("q, k, v must be bf16 with a contiguous last dim")
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError("q, k, v need 16-byte strides and pointers")
    if max(k.stride(1), v.stride(1)) * TILE_SLOTS >= 2 ** 31:
        raise ValueError("k, v slot strides too large for the kernel's 32-bit tile offsets")
    if pos.dtype != torch.int32 or slot_pos.dtype != torch.int32 \
            or slot_pos.stride(1) != 1:
        raise ValueError("pos / slot_pos must be int32, slot_pos rows contiguous")
    pos = pos.contiguous()   # the kernel reads pos[b] at stride 1
    if q.device not in _SMS:
        _SMS[q.device] = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = split_plan(B, H, Hkv, W, D, _SMS[q.device])
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        slot_pos.stride(0), o.stride(0), o.stride(1))
    fn = _build.function("flash_decode", "flash_decode_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            slot_pos.data_ptr(), o.data_ptr(), lse.data_ptr() if return_lse else None,
            scratch.data_ptr(), B, H, Hkv, W,
            D, strides, int(window), D ** -0.5, plan["n_split"], _build.stream_ptr(q))
    _build.check(_build.load("flash_decode"), rc, "flash_decode")
    flash_decode.launches += 1
    return (o, lse) if return_lse else o


flash_decode.launches = 0
