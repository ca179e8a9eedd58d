"""Transformer primitives of the serving path (port of ``repro.models.layers``).

Plain functions on tensors, weights as dictionaries, the reference's layouts
and numerics: bf16 weights and activations, norm / rope / softmax statistics
in f32, and attention probabilities rounded to the V dtype before PV.

Prefill and decode attention take the hand-written kernels on a CUDA tensor
(``kernels/flash_attention.py``, ``kernels/flash_decode.py``). On the CPU
they take the reference's full ``attention`` instead, the function the JAX
serving engine itself runs, so the CPU parity tests hold the port to the
engine's own numbers. Chunked prefill has no kernel of its own: on the card
its C queries are folded into ``flash_decode``'s batch dimension, each
reading the request's one cache row through a batch stride of 0 (the
valid-key set ``0 <= slot_pos <= pos`` is the reference mask's).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode

PDT = torch.bfloat16  # param / activation dtype

NEG_INF = -1e9  # mask value (f32-safe); the kernels use their own -1e30


def vocab_pad_of(vocab: int) -> int:
    return -(-vocab // 128) * 128


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


def _qkv(x, p, dims: AttnDims, positions, use_rope=True):
    B, S, _ = x.shape
    H, Hkv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if dims.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if dims.qk_norm:
        q = rms_norm(q, p["q_norm"], dims.rms_eps)
        k = rms_norm(k, p["k_norm"], dims.rms_eps)
    if use_rope:
        q = rope(q, positions, dims.rope_theta)
        k = rope(k, positions, dims.rope_theta)
    return q, k, v


def self_attn_full(x, p, dims: AttnDims, *, window=None, causal=True):
    """Full-sequence self attention (prefill). x: [B,S,d].
    Returns (out [B,S,d], (k, v) each [B,S,Hkv,hd])."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(x, p, dims, positions)
    if x.is_cuda:
        o = flash_attention(q, k, v, causal=causal,
                            window=-1 if window is None else int(window))
    else:
        o = attention(q, k, v, q_pos=positions, k_pos=positions,
                      window=window, causal=causal)
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def self_attn_decode(x, p, dims: AttnDims, cache_k, cache_v, slot_pos, slot: int,
                     pos: Union[int, torch.Tensor], *, window=None):
    """One-token decode against a ring-buffer cache.

    x: [B,1,d]; cache_k/v: [B,W,Hkv,hd], written IN PLACE at ``slot`` (the
    reference returns fresh arrays; the port saves the copy); slot_pos: [W]
    absolute position per slot, already holding ``pos`` at ``slot`` (-1 =
    empty); pos: absolute position of the new token, an int or an int32
    tensor of shape [] / [B] on x's device. Returns (out, cache_k, cache_v).
    """
    B = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).reshape(-1).expand(B)
    positions = pos_b[:, None]
    q, k, v = _qkv(x, p, dims, positions)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    if x.is_cuda:
        o = flash_decode(q[:, 0], cache_k, cache_v, pos_b,
                         slot_pos[None].expand(B, -1),
                         window=-1 if window is None else int(window))
        o = o[:, None]
    else:
        o = attention(q, cache_k, cache_v, q_pos=positions,
                      k_pos=slot_pos[None], window=window, causal=True)
    return o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


def self_attn_prefill_chunk(x, p, dims: AttnDims, cache_k, cache_v, slot_pos,
                            start: int, *, window=None):
    """Chunked prefill: C prompt tokens attend over the request's
    already-written KV prefix plus themselves, appending their K/V.

    x: [B,C,d]; cache_k/v: [B,W,Hkv,hd] and slot_pos: [B,W] int32 (-1 =
    empty), all written IN PLACE at slots start..start+C-1 (prefill never
    wraps the ring: start + C <= W is the caller's invariant). On the card
    (one request, B = 1, as the engines call it) the C queries run as one
    ``flash_decode`` call: q [C,H,D], pos = start + arange(C), and the
    cache and slot_pos expanded to C rows with a batch stride of 0.
    Returns (out, cache_k, cache_v, slot_pos)."""
    B, C, _ = x.shape
    positions = (start + torch.arange(C, dtype=torch.int32, device=x.device)
                 )[None].expand(B, C)
    q, k, v = _qkv(x, p, dims, positions)
    cache_k[:, start:start + C] = k
    cache_v[:, start:start + C] = v
    slot_pos[:, start:start + C] = positions
    if x.is_cuda:
        if B != 1:
            raise ValueError(f"chunked prefill on the card takes one request, got B={B}")
        W = cache_k.shape[1]
        o = flash_decode(q[0], cache_k.expand(C, W, -1, -1),
                         cache_v.expand(C, W, -1, -1), positions[0].contiguous(),
                         slot_pos.expand(C, W),
                         window=-1 if window is None else int(window))[None]
    else:
        o = attention(q, cache_k, cache_v, q_pos=positions, k_pos=slot_pos,
                      window=window, causal=True)
    return o.reshape(B, C, -1) @ p["wo"], cache_k, cache_v, slot_pos


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
    return o.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


def matmul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` whose every row is the same whatever the number of rows of
    ``a``: a single row is padded to two, because the CPU's f32 product
    takes another path for one row (a matrix-vector product that sums in
    another order) and would part a request served alone from the same
    request in a batch."""
    if a.shape[-2] != 1:
        return torch.matmul(a, b)
    return torch.matmul(torch.cat([a, torch.zeros_like(a)], -2), b)[..., :1, :]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` [M,K] x [K,N] with an f32 result, as XLA computes a
    bf16 product whose f32 cast it folds in (the JAX engine's head and
    ``expert_raw``): on the card one cuBLAS product with an f32 output, on
    the CPU the f32 product of the bf16 values, row-invariant."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return matmul_rows(a.float(), b.float())


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` primitive by primitive (x * 1 / (1 + exp(-x))), each
    step rounded to x's dtype as XLA rounds a bf16 program; ``F.silu``
    rounds once and parts from the reference by a bf16 ulp."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu_hidden(x, w1, w3):
    return silu(x @ w1) * (x @ w3)


def swiglu(x, w1, w3, w2):
    return swiglu_hidden(x, w1, w3) @ w2
