"""Transformer primitives of the serving path (port of ``repro.models.layers``).

Plain functions on tensors, weights as dictionaries, the reference's layouts
and numerics: bf16 weights and activations, norm / rope / softmax statistics
in f32, and attention probabilities rounded to the V dtype before PV.

Prefill and decode attention take the hand-written kernels on a CUDA tensor
(``kernels/flash_attention.py``, ``kernels/flash_decode.py``; under autograd
``FlashAttentionFn``, the kernel's forward with a plain blockwise backward).
On the CPU they take the reference's full ``attention`` instead, the
function the JAX serving engine itself runs, so the CPU parity tests hold
the port to the engine's own numbers; at and above the reference's
``CHUNKED_MIN_SEQ`` a training or prefill bundle asks for the chunked path
(``chunked=True``), which on the CPU is the reference's own
``flash_attention_xla``: a blockwise online softmax with a flash backward.
Chunked prefill runs ``flash_attention_chunk`` on the card: the chunk's C
queries at their absolute positions over the request's KV row, masked by
its slot positions (the reference mask's valid-key set ``0 <= slot_pos <=
pos``); decode runs ``flash_decode``. Cross attention to a fixed memory
(the vlm's image patches, the enc-dec decoder's encoder output) runs
``flash_attention_cross`` over the whole sequence (under autograd
``FlashAttentionCrossFn``) and ``flash_decode`` with
every memory slot at position 0 for one token (the reference's
``cross_attn_decode`` masks nothing: ``q_pos = k_pos = 0``); on the CPU the
reference's ``attention`` with ``causal=False``.

Tensor parallelism (``self_attn_full(..., tp=)``, ``swiglu(..., tp=)``): what
GSPMD derives in the reference from the param specs
(``launch/partition.py``) is explicit here. Query heads are column-parallel
where ``wq`` is sharded (n_heads divides the model axis), K/V heads where
``wk`` is too (n_kv_heads divides it); replicated K/V are projected whole
and each rank takes the heads its query heads read (32 / 8 heads at 16
ranks: two query heads and one KV head a rank). ``wo`` is row-parallel,
then summed over the axis; an MLP's w1 / w3 column- and w2 row-parallel
(``row_parallel``: the partial products summed in f32, rounded once).
Where no weight is sharded the layer runs whole on every rank and
communicates nothing. A weight that stays replicated inside a sharded
region (``q_norm`` over the local heads) enters through
``collectives.copy_to``, so its gradient is summed over the ranks. Decode
(``self_attn_decode(..., tp=)``) follows the cache's layout
(``launch/partition.py cache_specs``): KV heads sharded as above, or the
ring's slots sharded, the ranks' blocks merged by log-sum-exp
(``collectives.lse_combine``). Cross attention (``cross_kv``,
``cross_attn_full``, ``cross_attn_decode``, each with ``tp=``) follows the
same rules, its memory K/V in ``cache_specs``' layout: KV heads sharded,
the memory's slots sharded (the decode's blocks merged by log-sum-exp), or
replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import collectives as C
from repro_torch.kernels.flash_attention import (FlashAttentionCrossFn, FlashAttentionFn,
                                                 flash_attention, flash_attention_bwd_plain,
                                                 flash_attention_chunk,
                                                 flash_attention_cross)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import opt_flags

PDT = torch.bfloat16  # param / activation dtype

NEG_INF = -1e9  # mask value (f32-safe); the kernels use their own -1e30


def vocab_pad_of(vocab: int) -> int:
    return -(-vocab // 128) * 128


def upload(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (or nested list) as a new tensor on ``device``, never a
    view of ``a``. To the card it goes through pinned memory with
    ``non_blocking=True``: an upload from pageable memory makes the host wait
    for the stream, a pinned one does not. The pinned copy is a block of the
    caching host allocator, which records an event on the copy and reuses the
    block only once that event has passed, so ``a`` may be overwritten as
    soon as this returns."""
    t = torch.tensor(np.asarray(a), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotation in f32. x: [..., S, H, D]; positions
    broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                 # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def _mask(qp: torch.Tensor, kp: torch.Tensor, window, causal: bool) -> torch.Tensor:
    """Boolean [..., Sq, Sk] validity from absolute positions.
    window: None or < 0 means unbounded; kp < 0 marks empty slots."""
    qp = qp[..., :, None]
    kp = kp[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None and window >= 0:
        ok = ok & (kp > qp - window)
    return ok


def attention(q, k, v, *, q_pos, k_pos, window=None, causal=True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Reference full attention. q: [B,Sq,H,D]; k,v: [B,Sk,Hkv,D];
    q_pos [B,Sq] (or [Sq]); k_pos [B,Sk] (or [Sk]), negative = empty slot.
    Returns [B,Sq,H,D]."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    m = _mask(q_pos, k_pos, window, causal)[:, None, None]  # [B,1,1,Sq,Sk]
    p = torch.softmax(logits.masked_fill(~m, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def _chunked_fwd_with_lse(q, k, v, *, window, causal, q_block, kv_block, scale,
                          bf16_tiles=False):
    """Blockwise online-softmax attention over position-aligned q/k (the
    reference's ``attention_chunked`` and ``_chunked_fwd_with_lse``): per
    query block a scan over key blocks with a running max, sum and f32
    accumulator; masked entries -1e9. Returns (o [B,S,H,D] in q's dtype,
    each row's log-sum-exp [B,H,S] f32)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qb, kb = min(q_block, S), min(kv_block, S)
    pos = torch.arange(S, device=q.device)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)   # [B,Hkv,S,D]
    outs, lses = [], []
    for i0 in range(0, S, qb):
        i1 = min(S, i0 + qb)
        qblk = q[:, i0:i1].float().reshape(B, i1 - i0, Hkv, G, D).permute(0, 2, 3, 1, 4)
        m = torch.full((B, Hkv, G, i1 - i0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, i1 - i0, D), device=q.device)
        for j0 in range(0, S, kb):
            j1 = min(S, j0 + kb)
            lg = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kf[:, :, j0:j1]) * scale
            msk = _mask(pos[i0:i1], pos[j0:j1], window, causal)
            lg = lg.masked_fill(~msk, NEG_INF)
            m_cur = torch.maximum(m, lg.amax(-1))
            p = torch.exp(lg - m_cur[..., None])
            corr = torch.exp(m - m_cur)
            l = l * corr + p.sum(-1)
            vblk = vf[:, :, j0:j1]
            if bf16_tiles:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16),
                                  vblk.to(torch.bfloat16)).float()
            else:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p, vblk)
            acc = acc * corr[..., None] + pv
            m = m_cur
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
        lses.append(m + torch.log(torch.clamp(l, min=1e-20)))
    o = torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return o.to(q.dtype), torch.cat(lses, 3).reshape(B, H, S)


def attention_chunked(q, k, v, *, window=None, causal=True, q_block=512,
                      kv_block=512, scale: Optional[float] = None,
                      bf16_tiles: Optional[bool] = None) -> torch.Tensor:
    """Flash-style online-softmax attention over position-aligned q/k.
    q: [B,S,H,D]; k,v: [B,S,Hkv,D]. Peak memory O(q_block * kv_block)
    logits. bf16_tiles (REPRO_OPT_ATTN_BF16): probability tiles rounded to
    bf16 before the PV product (running stats stay f32)."""
    if bf16_tiles is None:
        bf16_tiles = opt_flags.attn_bf16_tiles()
    return _chunked_fwd_with_lse(
        q, k, v, window=window, causal=causal, q_block=q_block, kv_block=kv_block,
        bf16_tiles=bf16_tiles, scale=scale if scale is not None else q.shape[-1] ** -0.5)[0]


def attention_chunked_windowed(q, k, v, *, window: int, q_block=512, kv_block=512,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Causal chunked attention restricted to a static window > 0 (the
    reference's ``attention_chunked_windowed``, REPRO_OPT_STATIC_WINDOW):
    query block i visits only the ``min(nk, (window + q_block - 1) //
    kv_block + 2)`` key blocks from ``clip((i q_block - window) //
    kv_block, 0, nk - trips)`` that can meet its band, in order, with the
    online softmax of ``attention_chunked`` (f32 probabilities); keys
    outside the band or past the causal frontier are masked."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qb, kb = min(q_block, S), min(kv_block, S)
    nq, nk = -(-S // qb), -(-S // kb)
    trips = min(nk, (window + qb - 1) // kb + 2)
    kpos = torch.arange(nk * kb, device=q.device)
    kpos = torch.where(kpos < S, kpos, -1)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, nk * kb - S)).transpose(1, 2)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, nk * kb - S)).transpose(1, 2)
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, nq * qb - S))
    outs = []
    for qi in range(nq):
        qblk = qf[:, qi * qb:(qi + 1) * qb].reshape(B, qb, Hkv, G, D).permute(0, 2, 3, 1, 4)
        qpos = qi * qb + torch.arange(qb, device=q.device)
        j0 = min(max((qi * qb - window) // kb, 0), max(nk - trips, 0))
        m = torch.full((B, Hkv, G, qb), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, qb, D), device=q.device)
        for j in range(j0, j0 + trips):
            ks = slice(j * kb, (j + 1) * kb)
            lg = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kf[:, :, ks]) * scale
            lg = lg.masked_fill(~_mask(qpos, kpos[ks], window, True), NEG_INF)
            m_cur = torch.maximum(m, lg.amax(-1))
            p = torch.exp(lg - m_cur[..., None])
            corr = torch.exp(m - m_cur)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, ks])
            m = m_cur
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    o = torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(B, nq * qb, H, D)
    return o[:, :S].to(q.dtype)


class _FlashAttentionXLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_block, kv_block):
        o, lse = _chunked_fwd_with_lse(q, k, v, window=window, causal=causal,
                                       q_block=q_block, kv_block=kv_block,
                                       scale=q.shape[-1] ** -0.5)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, causal, q_block, kv_block)
        return o

    @staticmethod
    def backward(ctx, do):
        window, causal, q_block, kv_block = ctx.args
        dq, dk, dv = flash_attention_bwd_plain(
            *ctx.saved_tensors, do, causal=causal,
            window=-1 if window is None else window, q_block=q_block, kv_block=kv_block)
        return dq, dk, dv, None, None, None, None


def flash_attention_xla(q, k, v, window, causal=True, q_block=512, kv_block=512):
    """Chunked attention with a flash backward (the reference's custom-VJP
    ``flash_attention_xla``): the forward keeps only (o, lse), the backward
    recomputes probability tiles block by block
    (``kernels.flash_attention.flash_attention_bwd_plain``), so residuals
    are O(S) rather than the scan's every carry."""
    return _FlashAttentionXLA.apply(q, k, v, window, causal, q_block, kv_block)


def _qkv(x, p, dims: AttnDims, positions, use_rope=True, tp: Optional[C.Axis] = None):
    """q, k, v [B,S,heads,hd]. ``tp``: the model axis where ``wq`` is this
    rank's column block (module docstring): x enters through ``copy_to``,
    the query heads are the rank's, and so are the KV heads where ``wk`` is
    sharded too; where it is whole the KV heads are projected whole, all of
    them (``_select_kv`` takes the ones the local query heads read)."""
    B, S, _ = x.shape
    hd = dims.head_dim
    xin = C.copy_to(x, tp)
    q = linear(xin, p["wq"])
    h_loc = q.shape[-1] // hd
    whole_kv = h_loc < dims.n_heads and p["wk"].shape[-1] == dims.n_kv_heads * hd
    kin = x if whole_kv else xin
    k = linear(kin, p["wk"])
    v = linear(kin, p["wv"])
    if dims.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if dims.qk_norm:
        q = rms_norm(q, C.copy_to(p["q_norm"], tp), dims.rms_eps)
        k = rms_norm(k, p["k_norm"] if whole_kv else C.copy_to(p["k_norm"], tp), dims.rms_eps)
    if use_rope:
        q = rope(q, positions, dims.rope_theta)
        k = rope(k, positions, dims.rope_theta)
    return q, k, v


def _heads_axis(p, dims: AttnDims, tp: Optional[C.Axis]) -> Optional[C.Axis]:
    """``tp`` where ``wq`` is sharded over it, else None (the layer whole)."""
    if tp is None or tp.size == 1 or p["wq"].shape[-1] == dims.n_heads * dims.head_dim:
        return None
    return tp


def _select_kv(k, v, tp: C.Axis, h_loc: int, dims: AttnDims):
    """Of whole k, v [B,S,Hkv,hd], the KV heads this rank's ``h_loc`` query
    heads read, after ``copy_to`` (their gradient is a partial sum)."""
    sel = _local_kv(tp.index * h_loc, h_loc, dims.n_heads // dims.n_kv_heads)
    return C.copy_to(k, tp)[:, :, sel], C.copy_to(v, tp)[:, :, sel].contiguous()


def _local_kv(q0: int, n: int, group: int):
    """The KV heads query heads q0 .. q0 + n - 1 read (head h reads h //
    group): a slice where each is read by n / (their count) consecutive
    query heads (a uniform group for the kernel), else a list with one KV
    head per query head (group 1)."""
    heads = [(q0 + i) // group for i in range(n)]
    n_kv = heads[-1] - heads[0] + 1
    if n % n_kv == 0 and heads == [heads[0] + i // (n // n_kv) for i in range(n)]:
        return slice(heads[0], heads[-1] + 1)
    return heads


def self_attn_full(x, p, dims: AttnDims, *, window=None, causal=True,
                   chunked: bool = False, static_window: bool = False,
                   tp: Optional[C.Axis] = None):
    """Full-sequence self attention (train / prefill). x: [B,S,d].
    Returns (out [B,S,d], (k, v) each [B,S,Hkv,hd]).

    On the card the kernel, whatever ``chunked`` says (it skips the key
    tiles a window masks); where autograd records, ``FlashAttentionFn``
    (the kernel's forward, a plain flash backward). On the CPU the
    reference's choice: when ``chunked`` (the bundles set it at S >= 2048)
    ``attention_chunked_windowed`` for a causal ``static_window`` > 0 (the
    reference takes it for a window that is a Python int, as
    ``build_dense_pattern``'s are), else ``flash_attention_xla``; when not
    chunked the full ``attention``, differentiated by autograd.

    ``tp``: the model axis, ``p`` this rank's slice (module docstring); the
    attention runs over the local heads and the output projection is
    summed over the axis. (k, v) are the local KV heads where ``wk`` is
    sharded, else all of them (the decode cache's layout, ``launch/
    partition.py cache_specs``: its slots are sharded then, not its heads)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    tp = _heads_axis(p, dims, tp)
    q, k, v = _qkv(x, p, dims, positions, tp=tp)
    kv = (k, v)
    if tp is not None and k.shape[2] == dims.n_kv_heads:   # wk whole, wq sharded
        k, v = _select_kv(k, v, tp, q.shape[2], dims)
    win = -1 if window is None else int(window)
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            o = FlashAttentionFn.apply(q, k, v, causal, win)
        else:
            o = flash_attention(q, k, v, causal=causal, window=win)
    elif chunked and static_window and win > 0 and causal:
        o = attention_chunked_windowed(q, k, v, window=win)
    elif chunked:
        o = flash_attention_xla(q, k, v, win, causal)
    else:
        o = attention(q, k, v, q_pos=positions, k_pos=positions,
                      window=window, causal=causal)
    return row_parallel(o.reshape(B, S, -1), p["wo"], tp), kv


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot, lo: Optional[int] = None) -> None:
    """cache[:, slot] = new IN PLACE. cache [B,W,...], new [B,...]; ``slot``
    an int, or a tensor of one element on the cache's device (the decode
    step's ``pos % W``, never read on the host: an ``index_copy_``).
    With ``lo`` the cache is a block of a ring's slots, lo .. lo + W - 1,
    and only a slot inside it is written (at slot - lo): on the device the
    block's row at the clamped index is rewritten with the new row or with
    itself."""
    W = cache.shape[1]
    if isinstance(slot, int):
        if lo is None:
            cache[:, slot] = new
        elif lo <= slot < lo + W:
            cache[:, slot - lo] = new
        return
    i = slot.reshape(1).long()
    if lo is None:
        cache.index_copy_(1, i, new[:, None])
        return
    i = i - lo
    own = ((i >= 0) & (i < W)).reshape((1,) * cache.dim())
    i = i.clamp(0, W - 1)
    cache.index_copy_(1, i, torch.where(own, new[:, None], cache.index_select(1, i)))


def self_attn_decode(x, p, dims: AttnDims, cache_k, cache_v, slot_pos, slot,
                     pos: Union[int, torch.Tensor], *, window=None,
                     tp: Optional[C.Axis] = None):
    """One-token decode against a ring-buffer cache.

    x: [B,1,d]; cache_k/v: [B,W,Hkv,hd], written IN PLACE at ``slot`` (the
    reference returns fresh arrays; the port saves the copy); slot_pos: [W]
    absolute position per slot, already holding ``pos`` at ``slot`` (-1 =
    empty); slot: an int, or a one-element tensor on x's device (read on
    the device only); pos: absolute position of the new token, an int or
    an int32 tensor of shape [] / [B] on x's device. Returns (out,
    cache_k, cache_v).

    ``tp``: the model axis, ``p`` this rank's slice, the cache this rank's
    block in ``launch/partition.py cache_specs``' layout:

    * heads sharded (the KV heads divide the axis): as ``self_attn_full``,
      the local query and KV heads, ``wo`` summed over the axis;
    * slots sharded (cache_k [B,W/n,Hkv,hd] beside slot_pos [W]): every KV
      head is projected, the query heads gathered over the axis, the new
      K/V written only by the rank whose block holds ``slot``, and
      ``flash_decode`` runs over the rank's block with its log-sum-exp;
      the partials merge over the axis (``collectives.lse_combine``), the
      rank keeps its own heads for its rows of ``wo``, summed over the
      axis. A cache that neither divides (replicated) takes this path with
      one block and no merge."""
    B = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).reshape(-1).expand(B)
    positions = pos_b[:, None]
    win = -1 if window is None else int(window)
    tp_q = _heads_axis(p, dims, tp)
    if tp is None or tp.size == 1 or cache_k.shape[2] < dims.n_kv_heads:
        q, k, v = _qkv(x, p, dims, positions, tp=tp_q)
        write_slot(cache_k, k[:, 0], slot)
        write_slot(cache_v, v[:, 0], slot)
        if x.is_cuda:
            o = flash_decode(q[:, 0], cache_k, cache_v, pos_b,
                             slot_pos[None].expand(B, -1), window=win)[:, None]
        else:
            o = attention(q, cache_k, cache_v, q_pos=positions,
                          k_pos=slot_pos[None], window=window, causal=True)
        return row_parallel(o.reshape(B, 1, -1), p["wo"], tp_q), cache_k, cache_v
    q, k, v = _qkv(x, p, dims, positions, tp=tp_q)
    h_loc = q.shape[2]
    q = C.all_gather(q, tp_q, 2)
    W_loc = cache_k.shape[1]
    lo = tp.index * W_loc if W_loc < slot_pos.shape[0] else None   # the rank's block
    write_slot(cache_k, k[:, 0], slot, lo)
    write_slot(cache_v, v[:, 0], slot, lo)
    start = lo or 0
    o, lse = flash_decode(q[:, 0], cache_k, cache_v, pos_b,
                          slot_pos[start:start + W_loc][None].expand(B, -1), window=win,
                          return_lse=True)
    if lo is not None:
        o = C.lse_combine(o, lse, tp)
    if tp_q is not None:
        o = o[:, tp.index * h_loc:(tp.index + 1) * h_loc]
    return row_parallel(o.reshape(B, 1, -1), p["wo"], tp_q), cache_k, cache_v


def self_attn_prefill_chunk(x, p, dims: AttnDims, cache_k, cache_v, slot_pos,
                            start: int, *, window=None):
    """Chunked prefill: C prompt tokens attend over the request's
    already-written KV prefix plus themselves, appending their K/V.

    x: [B,C,d]; cache_k/v: [B,W,Hkv,hd] and slot_pos: [B,W] int32 (-1 =
    empty), all written IN PLACE at slots start..start+C-1 (prefill never
    wraps the ring: start + C <= W and slot j holds position j or -1 are
    the caller's invariants). On the card the C queries run as one
    ``flash_attention_chunk`` call over the cache views as given (the
    engine passes a view of its slot pool). Returns (out, cache_k,
    cache_v, slot_pos)."""
    B, C, _ = x.shape
    positions = (start + torch.arange(C, dtype=torch.int32, device=x.device)
                 )[None].expand(B, C)
    q, k, v = _qkv(x, p, dims, positions)
    cache_k[:, start:start + C] = k
    cache_v[:, start:start + C] = v
    slot_pos[:, start:start + C] = positions
    if x.is_cuda:
        o = flash_attention_chunk(q, cache_k, cache_v, slot_pos, start,
                                  window=-1 if window is None else int(window))
    else:
        o = attention(q, cache_k, cache_v, q_pos=positions, k_pos=slot_pos,
                      window=window, causal=True)
    return linear(o.reshape(B, C, -1), p["wo"]), cache_k, cache_v, slot_pos


def self_attn_decode_batched(x, p, dims: AttnDims, cache_k, cache_v, slot_pos,
                             slot: torch.Tensor, pos: torch.Tensor, *,
                             window=None):
    """One-token decode for B sequences at different positions.

    x: [B,1,d]; cache_k/v: [B,W,Hkv,hd], row b's new K/V written IN PLACE at
    ``slot[b]``; slot_pos: [B,W] int32, already holding ``pos[b]`` at
    ``slot[b]``; slot, pos: [B] tensors on x's device. Returns (out,
    cache_k, cache_v)."""
    B = x.shape[0]
    pos = pos.to(torch.int32)
    positions = pos.reshape(B, 1)
    q, k, v = _qkv(x, p, dims, positions)
    rows = torch.arange(B, device=x.device)
    slot = slot.long()
    cache_k[rows, slot] = k[:, 0]
    cache_v[rows, slot] = v[:, 0]
    if x.is_cuda:
        o = flash_decode(q[:, 0], cache_k, cache_v, pos, slot_pos,
                         window=-1 if window is None else int(window))[:, None]
    else:
        o = attention(q, cache_k, cache_v, q_pos=positions, k_pos=slot_pos,
                      window=window, causal=True)
    return linear(o.reshape(B, 1, -1), p["wo"]), cache_k, cache_v


def cross_kv(mem, p, dims: AttnDims, tp: Optional[C.Axis] = None):
    """Memory tokens [B,M,d] projected once to cross-attention K, V, each
    [B,M,Hkv,hd] (k normed with ``qk_norm``); no rope. ``tp``: the model
    axis where ``wk`` / ``wv`` are this rank's column blocks: the memory
    enters through ``copy_to`` and K, V are the rank's KV heads; where they
    are whole every KV head is projected (the memory cache's layout,
    ``launch/partition.py cache_specs``: its slots are sharded then, or
    nothing)."""
    B, M, _ = mem.shape
    hd = dims.head_dim
    local = tp is not None and p["wk"].shape[-1] < dims.n_kv_heads * hd
    tp = tp if local else None
    xin = C.copy_to(mem, tp)
    k = linear(xin, p["wk"]).reshape(B, M, -1, hd)
    v = linear(xin, p["wv"]).reshape(B, M, -1, hd)
    if dims.qk_norm:
        k = rms_norm(k, C.copy_to(p["k_norm"], tp), dims.rms_eps)
    return k, v


def _cross_q(x, p, dims: AttnDims, tp: Optional[C.Axis] = None):
    """The queries [B,S,heads,hd]: the rank's heads where ``wq`` is its
    column block (x entering through ``copy_to``), else all of them."""
    B, S, _ = x.shape
    q = linear(C.copy_to(x, tp), p["wq"]).reshape(B, S, -1, dims.head_dim)
    if dims.qk_norm:
        q = rms_norm(q, C.copy_to(p["q_norm"], tp), dims.rms_eps)
    return q


def cross_attn_full(x, p, dims: AttnDims, mem_k, mem_v, tp: Optional[C.Axis] = None):
    """Cross attention of x [B,S,d] to a fixed memory mem_k, mem_v
    [B,M,Hkv,hd]: every memory key valid for every query, no rope. On the
    card ``flash_attention_cross``; where autograd records,
    ``FlashAttentionCrossFn`` (the kernel's forward, a plain flash
    backward). On the CPU the reference's ``attention(causal=False)``,
    differentiated by autograd.

    ``tp``: the model axis, ``p`` this rank's slice, the memory in
    ``cross_kv(tp=)``'s layout: the query heads are the rank's where ``wq``
    is sharded, the KV heads the rank's where the memory holds them (else
    ``_select_kv`` picks the ones its query heads read), ``wo`` summed
    over the axis (``self_attn_full``'s rules)."""
    B, S, _ = x.shape
    tp = _heads_axis(p, dims, tp)
    q = _cross_q(x, p, dims, tp)
    if tp is not None and mem_k.shape[2] == dims.n_kv_heads:   # wk whole, wq sharded
        mem_k, mem_v = _select_kv(mem_k, mem_v, tp, q.shape[2], dims)
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, mem_k, mem_v)):
            o = FlashAttentionCrossFn.apply(q, mem_k, mem_v)
        else:
            o = flash_attention_cross(q, mem_k, mem_v)
    else:
        o = attention(q, mem_k, mem_v, q_pos=torch.arange(S, device=x.device)[None],
                      k_pos=torch.arange(mem_k.shape[1], device=x.device)[None],
                      causal=False)
    return row_parallel(o.reshape(B, S, -1), p["wo"], tp)


def cross_attn_decode(x, p, dims: AttnDims, mem_k, mem_v, tp: Optional[C.Axis] = None,
                      mem_slots: Optional[int] = None):
    """One token x [B,1,d] against a cached memory mem_k, mem_v
    [B,M,Hkv,hd]. The reference puts the query and every memory slot at
    position 0 without a causal mask; on the card ``flash_decode`` with
    ``pos`` 0 and every slot's position 0 computes the same.

    ``tp``: the model axis, ``p`` this rank's slice, the memory this rank's
    block in ``launch/partition.py cache_specs``' layout (``mem_slots``:
    the whole memory's slot count):

    * heads sharded (mem_k holds fewer than ``n_kv_heads``): the rank's
      query and KV heads, ``wo`` summed over the axis;
    * slots sharded (mem_k [B, mem_slots / n, Hkv, hd]): the query heads
      gathered over the axis where ``wq`` is sharded, ``flash_decode`` over
      the rank's block of slots with its log-sum-exp, the blocks merged
      over the axis (``collectives.lse_combine``), the rank's own heads kept
      for its rows of ``wo``, summed over the axis;
    * replicated (neither divides): that path over the one whole block,
      with no merge."""
    B = x.shape[0]
    M = mem_k.shape[1]
    zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
    tp_q = _heads_axis(p, dims, tp)
    q = _cross_q(x, p, dims, tp_q)
    if tp is None or tp.size == 1 or mem_k.shape[2] < dims.n_kv_heads:
        if x.is_cuda:
            sp = torch.zeros((M,), dtype=torch.int32, device=x.device)[None].expand(B, M)
            o = flash_decode(q[:, 0], mem_k, mem_v, zero, sp)[:, None]
        else:
            o = attention(q, mem_k, mem_v, q_pos=zero[:, None],
                          k_pos=torch.zeros((1, M), dtype=torch.int32, device=x.device),
                          causal=False)
        return row_parallel(o.reshape(B, 1, -1), p["wo"], tp_q)
    h_loc = q.shape[2]
    q = C.all_gather(q, tp_q, 2)
    sp = torch.zeros((M,), dtype=torch.int32, device=x.device)[None].expand(B, M)
    o, lse = flash_decode(q[:, 0], mem_k, mem_v, zero, sp, return_lse=True)
    if mem_slots is not None and M < mem_slots:
        o = C.lse_combine(o, lse, tp)
    if tp_q is not None:
        o = o[:, tp.index * h_loc:(tp.index + 1) * h_loc]
    return row_parallel(o.reshape(B, 1, -1), p["wo"], tp_q)


ROW_BLOCK = 128   # rows of every product ``linear`` issues on the card


def _row_blocks(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [n, K] @ w [K, N] in calls of ``ROW_BLOCK`` rows (the last
    block padded with zeros)."""
    n = rows.shape[0]
    if n % ROW_BLOCK:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % ROW_BLOCK))
    out = rows.new_empty(rows.shape[0], w.shape[1])
    for i in range(0, rows.shape[0], ROW_BLOCK):
        torch.mm(rows[i:i + ROW_BLOCK], w, out=out[i:i + ROW_BLOCK])
    return out[:n]


class _Linear(torch.autograd.Function):
    """``linear`` on the card with a gradient: dx = dy w^T in the same
    fixed row blocks (a row's gradient does not depend on the rows beside
    it either), dw = x^T dy in one product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        rows = x.reshape(-1, x.shape[-1])
        return _row_blocks(rows, w).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _row_blocks(dy2, w.t().to(x.dtype)).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).t() @ dy2).to(w.dtype)
        return dx, dw


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K], w [K, N] whose every row is the same
    whatever the rows beside it. On the card the product runs in calls of a
    fixed ``ROW_BLOCK`` rows (the last block padded with zeros). cuBLAS
    picks its algorithm, and with it the order of the sums, by the number
    of rows: the plain product moves a row of ``x @ wk`` by bf16 ulps and
    a router row in its last f32 bits with the row count (``chip_smoke.py``
    measures both, ``row_drift``), which parted chunked from monolithic
    prefill at Mixtral width and so one replica's tokens from another's.
    Differentiable (``_Linear``; ``torch.mm(out=)`` alone is not). On the
    CPU the plain product."""
    if not x.is_cuda:
        return x @ w
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Linear.apply(x, w)
    return _row_blocks(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp: Optional[C.Axis]) -> torch.Tensor:
    """``linear(x, w)`` where w's rows (x's last dim) are this rank's block
    of the model axis, summed over it. The partial products come in f32
    (``mm_f32``), are summed in f32 and rounded once to x's type, so the
    result is the unsharded product up to the order of its f32 sums; bf16
    partials summed in bf16 would round each rank's part and then the sum.
    Without an axis, ``linear``."""
    if tp is None or tp.size == 1:
        return linear(x, w)
    part = mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])
    return C.reduce_from(part, tp).to(x.dtype)


def matmul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` whose every row is the same whatever the number of rows of
    ``a``: a single row is padded to two, because the CPU's f32 product
    takes another path for one row (a matrix-vector product that sums in
    another order) and would part a request served alone from the same
    request in a batch."""
    if a.shape[-2] != 1:
        return torch.matmul(a, b)
    return torch.matmul(torch.cat([a, torch.zeros_like(a)], -2), b)[..., :1, :]


class _MmF32(torch.autograd.Function):
    """``mm_f32`` on the card with a gradient (``torch.mm(out_dtype=)`` has
    none): da = dy b^T, db = a^T dy, in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.to(a.dtype)
        return dy @ b.t(), a.t() @ dy


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` [M,K] x [K,N] with an f32 result, as XLA computes a
    bf16 product whose f32 cast it folds in (the JAX engine's head and
    ``expert_raw``): on the card one cuBLAS product with an f32 output
    (differentiable, ``_MmF32``), on the CPU the f32 product of the bf16
    values, row-invariant."""
    if a.is_cuda:
        return _MmF32.apply(a, b)
    return matmul_rows(a.float(), b.float())


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` primitive by primitive (x * 1 / (1 + exp(-x))), each
    step rounded to x's dtype as XLA rounds a bf16 program; ``F.silu``
    rounds once and parts from the reference by a bf16 ulp."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu_hidden(x, w1, w3):
    return silu(x @ w1) * (x @ w3)


def swiglu(x, w1, w3, w2, tp: Optional[C.Axis] = None):
    """The shared-expert FFN. Its three products go through ``linear``, so
    a row's output does not depend on the rows beside it on the card (a
    decode batch, a prefill chunk or a whole prompt); on the CPU the plain
    products, as before. ``tp``: w1 / w3 column- and w2 row-parallel over
    the model axis (this rank's slices of the hidden dim), summed over it."""
    x = C.copy_to(x, tp)
    return row_parallel(silu(linear(x, w1)) * linear(x, w3), w2, tp)
