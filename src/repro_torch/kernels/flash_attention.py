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

``flash_attention_cross`` is cross attention to a fixed memory (the vlm's
image patches, the enc-dec decoder's encoder output): Sq queries over Sk
keys, no mask; the Pallas kernel has no such form (the reference runs XLA
``attention`` with ``causal=False`` there).

On a CUDA tensor each wrapper launches ``csrc/flash_attention.cu`` (wgmma
and TMA, for Hopper; the chunk form is a second entry point of the same
device code, the cross form the monolithic entry with its own key length),
head_dim 64, 112, 128 or 256 (the chunk form 64 or 128); on a CPU tensor it
runs its plain version. The kernel follows FlashAttention-3's schedule:
blocks of 128 query rows, two consumer warpgroups of 64 that take turns on
the tensor cores (ping-pong) and run each tile's softmax while the last
tile's PV is in flight, a producer warpgroup feeding K and V tiles (128
keys at head_dim 64, 96 at 112 and 128) by TMA, and o written by TMA
store; at head_dim 256 a block is one warpgroup of 64 rows over 64-key
tiles. The grid, ``(H, B, ceil(Sq / rows a block))``, is the C entry's
own. ``flash_attention.launches``,
``flash_attention_chunk.launches`` and ``flash_attention_cross.launches``
count kernel launches.

``flash_attention(..., return_lse=True)`` (and ``flash_attention_cross``)
also gives each query row's log-sum-exp of its scaled logits, ``[B,H,Sq]``
f32 in natural log; ``o`` is the same with or without it.
``FlashAttentionFn`` is the monolithic form with a gradient, and
``FlashAttentionCrossFn`` the cross form: the forward is the kernel on the
card (the plain version on the CPU) and the backward recomputes the
probability tiles from (q, k, v, o, lse) block by block in plain PyTorch
(``flash_attention_bwd_plain``), as the reference's custom VJP
``repro.models.layers._fa_bwd`` does in XLA. The Pallas kernel has no
backward; a kernel for this one is later work. A launch has no gradient of
its own, so each wrapper raises on the card where autograd records.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 112, 128, 256)
PLAIN_BLOCK_ELEMS = 1 << 28   # f32 logits the plain version holds at once
CHUNK_HEAD_DIMS = (64, 128)
# q, k, v, o, lse, B, Sq, Sk, H, Hkv, D, strides, causal, window, scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
# q, k, v, slot_pos, o, B, C, W, H, Hkv, D, strides, spb, q_start, window,
# scale, stream
_CHUNK_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _valid(qi, ki, causal: bool, window: int):
    """[Sq, Sk] validity of query positions qi against key positions ki."""
    ok = torch.ones((qi.shape[0], ki.shape[0]), dtype=torch.bool, device=qi.device)
    if causal:
        ok &= ki[None] <= qi[:, None]
    if window > 0:
        ok &= ki[None] > qi[:, None] - window
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = -1,
                          return_lse: bool = False):
    """Plain PyTorch version: one softmax over all keys, the kernel's
    arithmetic (unnormalised p rounded to bf16, divided by the f32 sum).
    With ``return_lse`` also the rows' log-sum-exp, [B,H,S] f32. Without a
    causal mask k and v may hold another number of keys than q of queries
    (cross attention). Where the f32 logits of all rows would pass
    ``PLAIN_BLOCK_ELEMS`` entries (S = 32768 is 17 G of them a head), the
    rows go in blocks of that many entries, each over the keys its mask can
    reach: a row's softmax is its own, and a masked key adds an exact 0."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    rows = max(1, PLAIN_BLOCK_ELEMS // (B * H * Sk))
    if rows >= S:
        return _plain_rows(q, k, v, 0, 0, causal, window, return_lse)
    outs = []
    for i0 in range(0, S, rows):
        i1 = min(S, i0 + rows)
        k0 = max(0, i0 - window + 1) if window > 0 else 0
        k1 = min(i1, Sk) if causal else Sk
        outs.append(_plain_rows(q[:, i0:i1], k[:, k0:k1], v[:, k0:k1], i0, k0, causal,
                                window, return_lse))
    if not return_lse:
        return torch.cat(outs, 1)
    return torch.cat([o for o, _ in outs], 1), torch.cat([l for _, l in outs], 2)


def _plain_rows(q, k, v, q0: int, k0: int, causal: bool, window: int, return_lse: bool):
    """``flash_attention_plain`` of the queries at positions q0.. over the
    keys at positions k0..."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    s = s.masked_fill(~_valid(torch.arange(q0, q0 + S, device=q.device),
                              torch.arange(k0, k0 + k.shape[1], device=q.device), causal,
                              window),
                      NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-20)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(torch.clamp(l, min=1e-20)))[..., 0].reshape(B, H, S)


def _check_qkv(q, k, v):
    """What the kernel's tensor maps take: bf16 on one device, head_dim in
    ``HEAD_DIMS``, a contiguous last dim, 16-byte strides and pointers."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]}: the kernel is built for {HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError("q, k, v must be bf16 on one device")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("need a contiguous last dim and 16-byte strides")


def _launch(q, k, v, causal: bool, window: int, return_lse: bool):
    """The monolithic kernel on q [B,Sq,H,D] over k, v [B,Sk,Hkv,D]."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or H % Hkv or (causal and Sk != Sq):
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    _check_qkv(q, k, v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, Hkv, D, strides,
            int(causal), int(window), D ** -0.5, _build.stream_ptr(q))
    _build.check(_build.load("flash_attention"), rc, "flash_attention")
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    return_lse: bool = False):
    """q: [B,S,H,D]; k, v: [B,S,Hkv,D] -> o [B,S,H,D], and with
    ``return_lse`` (o, lse [B,H,S] f32)."""
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention: mixed CPU/CUDA tensors")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)}: one length")
    _build.refuse_grad("flash_attention (use FlashAttentionFn)", q, k, v)
    o, lse = _launch(q, k, v, causal, window, return_lse)
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_cross(q, k, v, *, return_lse: bool = False):
    """Cross attention: q [B,Sq,H,D] over a memory's k, v [B,Sk,Hkv,D],
    every key valid -> [B,Sq,H,D], and with ``return_lse`` (o, lse [B,H,Sq]
    f32). The reference's ``attention(causal=False, window=None)`` over the
    memory."""
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention_cross: mixed CPU/CUDA tensors")
        return flash_attention_plain(q, k, v, causal=False, return_lse=return_lse)
    _build.refuse_grad("flash_attention_cross (use FlashAttentionCrossFn)", q, k, v)
    o, lse = _launch(q, k, v, False, -1, return_lse)
    flash_attention_cross.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cross.launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = -1, q_block: int = 512,
                              kv_block: int = 512):
    """Gradients (dq, dk, dv) of attention o = softmax(q k^T D^-0.5) v, in
    f32 from the saved (o, lse) without the S x S probabilities: for each
    KV block (outer) and query block (inner) the tile p = exp(s - lse) is
    recomputed, ds = p (do v^T - rowsum(do o)) D^-0.5, dv += p^T do,
    dk += ds^T q, dq += ds k; the port of ``repro.models.layers._fa_bwd``,
    block for block. Tiles that the mask empties are skipped (they add
    exact zeros). q, o, do: [B,Sq,H,D]; k, v: [B,Sk,Hkv,D]; lse [B,H,Sq].
    Without a causal mask Sk may differ from Sq (cross attention; with
    ``window <= 0`` nothing is masked)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if causal and Sk != Sq:
        raise ValueError(f"causal attention over {Sk} keys for {Sq} queries")
    G = H // Hkv
    scale = D ** -0.5
    grp = lambda t: t.float().reshape(B, Sq, Hkv, G, D)
    qf, dof = grp(q), grp(do)
    kf, vf = k.float(), v.float()
    delta = (dof * grp(o)).sum(-1).permute(0, 2, 3, 1)    # [B,Hkv,G,Sq]
    lse = lse.float().reshape(B, Hkv, G, Sq)
    qpos, kpos = torch.arange(Sq, device=q.device), torch.arange(Sk, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0 in range(0, Sk, kv_block):
        j1 = min(Sk, j0 + kv_block)
        kb, vb = kf[:, j0:j1], vf[:, j0:j1]
        for i0 in range(0, Sq, q_block):
            i1 = min(Sq, i0 + q_block)
            if (causal and i1 - 1 < j0) or (window > 0 and j1 - 1 <= i0 - window):
                continue
            qb, dob = qf[:, i0:i1], dof[:, i0:i1]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            s = s.masked_fill(~_valid(qpos[i0:i1], kpos[j0:j1], causal, window), NEG_INF)
            p = torch.exp(s - lse[..., i0:i1, None])
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - delta[..., i0:i1, None]) * scale
            dv[:, j0:j1] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            dk[:, j0:j1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
            dq[:, i0:i1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is the kernel on the
    card (the plain version on the CPU) with its lse output, the backward
    ``flash_attention_bwd_plain``. ``apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = -1):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=ctx.causal,
                                               window=ctx.window)
        return dq, dk, dv, None, None


class FlashAttentionCrossFn(torch.autograd.Function):
    """``flash_attention_cross`` with a gradient: the forward is the kernel
    on the card (the plain version on the CPU) with its lse output, the
    backward ``flash_attention_bwd_plain`` without a mask over the Sk memory
    keys. ``apply(q, k, v)``."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_cross(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)


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
    _build.refuse_grad("flash_attention_chunk", q, k, v)
    if D not in CHUNK_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the chunk kernel is built for {CHUNK_HEAD_DIMS}")
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
