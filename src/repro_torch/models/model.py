"""Model bundles (port of ``repro.models.model``): ``build_dense`` for the
dense and MoE decoder families (qwen3, granite, qwen1.5, gemma3, qwen2-moe,
kimi-k2, mixtral) and ``build_ssm`` for the ssm family.

``build(cfg)`` gives the reference's entry points:

  * ``init(seed, device)``           -> params (``models/params.py``)
  * ``forward(params, batch)``       -> (logits [B,S,Vp], aux) — teacher-forced
  * ``prefill(params, batch)``       -> (last_logits [B,Vp], cache)
  * ``decode_step(params, step, cache)`` -> (logits [B,Vp], cache)
  * ``init_cache(batch_size, ...)``  -> an empty cache

``batch`` = {'tokens': [B,S]}, ``step`` = {'token': [B,1]}, int tensors on
the params' device. Layers run in a Python loop (the reference's
``lax.scan``); while autograd records, each block of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``:
its activations are recomputed in the backward). ``decode_step`` returns a
new cache and leaves its argument as it was, as the reference's does.

Dense / MoE cache: ``k``, ``v`` [L,B,W,Hkv,hd] bf16 ring buffers (``k0``,
``v0`` for the leading dense layers), ``slot_pos`` [W] int32 absolute
position per slot (-1 = empty) and ``pos``; ``pad_cache`` grows the ring
after prefill. ssm cache: ``ssm [L,B,h,n,p]`` f32, ``conv_x/B/C
[L,B,C,K]`` bf16 and ``pos``.

The families with other builders (vlm, audio enc-dec, hybrid) and the
pattern-block gemma3 variant (``REPRO_OPT_STATIC_WINDOW``) are not ported
yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe_layer as M
from repro_torch.models import opt_flags
from repro_torch.models import ssm as S
from repro_torch.models.params import attn_dims, init_params

CHUNKED_MIN_SEQ = 2048  # the reference's switch to chunked (flash) attention


def _logits(x, embed):
    return x @ embed.T.to(x.dtype)


def _embed(embed, tokens):
    """Rows of ``embed``, ids clipped into range (the reference's
    ``mode="clip"``)."""
    return embed[tokens.long().clamp(0, embed.shape[0] - 1)]


def greedy_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the real vocabulary of padded logits [B,Vp] -> [B,1]."""
    return logits[:, :vocab].float().argmax(-1, keepdim=True).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable         # (seed, device) -> params
    forward: Callable      # (params, batch) -> (logits, aux)
    prefill: Callable      # (params, batch) -> (last_logits, cache)
    decode_step: Callable  # (params, step, cache) -> (logits, cache)
    init_cache: Callable   # (batch_size, ...) -> cache
    ring_axes: Dict[str, int] = dataclasses.field(default_factory=dict)


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "ssm":
        return build_ssm(cfg)
    if cfg.family in ("dense", "moe"):
        if cfg.local_global_pattern and opt_flags.static_window():
            raise NotImplementedError(
                f"{cfg.name}: REPRO_OPT_STATIC_WINDOW needs build_dense_pattern, "
                "not ported yet (ROADMAP Queue A5)")
        return build_dense(cfg)
    where = "A4" if cfg.family == "hybrid" else "A5"
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP Queue {where})")


def pad_cache(cache, new_capacity: int, ring_axes: Dict[str, int]):
    """Grow ring-buffer KV caches to ``new_capacity`` slots (zeros after
    the old ones, ``slot_pos`` -1). Valid right after prefill: the
    appended slots keep slot == pos % capacity while the prefill length
    <= old capacity <= new capacity."""
    new = dict(cache)
    for k, ax in ring_axes.items():
        if k not in cache:
            continue
        arr = cache[k]
        extra = new_capacity - arr.shape[ax]
        if extra <= 0:
            continue
        pads = [0, 0] * (arr.ndim - 1 - ax) + [0, extra]
        new[k] = torch.nn.functional.pad(arr, pads)
    sp = cache.get("slot_pos")
    if sp is not None and sp.shape[0] < new_capacity:
        new["slot_pos"] = torch.nn.functional.pad(sp, (0, new_capacity - sp.shape[0]),
                                                  value=-1)
    return new


# ---------------------------------------------------------------------------
# dense / moe decoder family
# ---------------------------------------------------------------------------


def _ffn_apply(xn, lp, cfg: ArchConfig, dropless: bool):
    if "moe" in lp:
        cf = None
        if dropless:
            cf = float(cfg.top_k * M.n_experts_padded(cfg))  # => C = T*k
        return M.moe_ffn(xn, lp["moe"], cfg, capacity_factor=cf)
    return L.swiglu(xn, lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"]), 0.0


def _block_full(x, lp, win: int, cfg: ArchConfig, chunked: bool):
    """One decoder block over a whole sequence. Returns (x, (k, v), aux)."""
    h, kv = L.self_attn_full(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"],
                             attn_dims(cfg), window=win, chunked=chunked)
    x = x + h
    y, aux = _ffn_apply(L.rms_norm(x, lp["ln2"], cfg.rms_eps), lp, cfg, dropless=False)
    return x + y, kv, aux


def _block_decode(x, lp, win: int, cfg: ArchConfig, ck, cv, sp, slot: int, pos):
    """One decoder block for one token; writes its K/V into ck, cv at
    ``slot`` in place. Returns (x, aux)."""
    h, _, _ = L.self_attn_decode(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"],
                                 attn_dims(cfg), ck, cv, sp, slot, pos, window=win)
    x = x + h
    y, aux = _ffn_apply(L.rms_norm(x, lp["ln2"], cfg.rms_eps), lp, cfg, dropless=True)
    return x + y, aux


def _stack(params, name: str):
    """The per-layer param dicts of stack ``name`` (views of its leaves)."""
    stack = params[name]
    n = stack["ln1"].shape[0]

    def at(node, l):
        return {k: at(v, l) for k, v in node.items()} if isinstance(node, dict) else node[l]

    return [at(stack, l) for l in range(n)]


def _records(x, lp) -> bool:
    """Whether autograd records a block on x with params lp."""
    def leaves(node):
        return [t for v in node.values() for t in leaves(v)] if isinstance(node, dict) else [node]
    return torch.is_grad_enabled() and (x.requires_grad
                                        or any(t.requires_grad for t in leaves(lp)))


def build_dense(cfg: ArchConfig) -> ModelBundle:
    n_dense = cfg.n_dense_layers
    windows = [cfg.window_for_layer(l) for l in range(n_dense, cfg.n_layers)]

    def init(seed: int = 0, device="cuda"):
        return init_params(cfg, seed, device, expert_slabs="device")

    def _stacks(params):
        """(cache key, layer params, window) of every layer, in order."""
        out = [("0", lp, -1) for lp in _stack(params, "dense0")] if n_dense else []
        return out + [("", lp, w) for lp, w in zip(_stack(params, "layers"), windows)]

    def forward(params, batch):
        tokens = batch["tokens"]
        x = _embed(params["embed"], tokens)
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        aux = 0.0
        for _, lp, win in _stacks(params):
            if _records(x, lp):
                x, _, a = checkpoint(_block_full, x, lp, win, cfg, chunked,
                                     use_reentrant=False)
            else:
                x, _, a = _block_full(x, lp, win, cfg, chunked)
            aux = aux + a
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _logits(x, params["embed"]), aux / cfg.n_layers

    def prefill(params, batch):
        tokens = batch["tokens"]
        B, Ssz = tokens.shape
        x = _embed(params["embed"], tokens)
        chunked = Ssz >= CHUNKED_MIN_SEQ
        kv = {"": [], "0": []}
        for key, lp, win in _stacks(params):
            x, (k, v), _ = _block_full(x, lp, win, cfg, chunked)
            kv[key].append((k, v))
        cache = {}
        for key, rows in kv.items():
            if rows:
                cache["k" + key] = torch.stack([k for k, _ in rows])
                cache["v" + key] = torch.stack([v for _, v in rows])
        dev = tokens.device
        cache["slot_pos"] = torch.arange(Ssz, dtype=torch.int32, device=dev)
        cache["pos"] = torch.tensor(Ssz, dtype=torch.int32, device=dev)
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _logits(x[:, -1], params["embed"]), cache

    def decode_step(params, step, cache):
        x = _embed(params["embed"], step["token"])
        pos = cache["pos"]
        W = cache["k"].shape[2]
        slot = int(pos) % W
        new = dict(cache)
        new["slot_pos"] = cache["slot_pos"].clone()
        new["slot_pos"][slot] = pos
        for key in ("k", "v", "k0", "v0"):
            if key in cache:
                new[key] = cache[key].clone()
        count = {"": 0, "0": 0}
        for key, lp, win in _stacks(params):
            l = count[key]
            count[key] += 1
            x, _ = _block_decode(x, lp, win, cfg, new["k" + key][l], new["v" + key][l],
                                 new["slot_pos"], slot, pos)
        new["pos"] = pos + 1
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _logits(x[:, -1], params["embed"]), new

    def init_cache(batch_size: int, capacity: int, device="cuda"):
        shape = (batch_size, capacity, cfg.n_kv_heads, cfg.hd)
        c = {"k": torch.zeros((cfg.n_layers - n_dense,) + shape, dtype=L.PDT, device=device),
             "slot_pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
             "pos": torch.tensor(0, dtype=torch.int32, device=device)}
        c["v"] = torch.zeros_like(c["k"])
        if n_dense:
            c["k0"] = torch.zeros((n_dense,) + shape, dtype=L.PDT, device=device)
            c["v0"] = torch.zeros_like(c["k0"])
        return c

    return ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                       ring_axes={"k": 2, "v": 2, "k0": 2, "v0": 2})


# ---------------------------------------------------------------------------
# ssm family (mamba2)
# ---------------------------------------------------------------------------


def _layer(params, l: int):
    return params["layers"]["ln"][l], {k: v[l] for k, v in params["layers"]["ssm"].items()}


def build_ssm(cfg: ArchConfig) -> ModelBundle:

    def init(seed: int = 0, device="cuda"):
        return init_params(cfg, seed, device)

    def _run_full(params, tokens, emit_state):
        x = _embed(params["embed"], tokens)
        states = []
        for l in range(cfg.n_layers):
            ln, lp = _layer(params, l)
            y, hfin, tails = S.ssd_forward(L.rms_norm(x, ln, cfg.rms_eps), lp, cfg)
            if emit_state:
                states.append((hfin, tails))
            x = x + y
        return L.rms_norm(x, params["ln_f"], cfg.rms_eps), states

    def forward(params, batch):
        x, _ = _run_full(params, batch["tokens"], emit_state=False)
        return _logits(x, params["embed"]), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        x, states = _run_full(params, tokens, emit_state=True)
        cache = {"ssm": torch.stack([h for h, _ in states]),
                 "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=params["embed"].device)}
        for k in ("x", "B", "C"):
            cache[f"conv_{k}"] = torch.stack([t[k] for _, t in states])
        return _logits(x[:, -1], params["embed"]), cache

    def decode_step(params, step, cache):
        x = _embed(params["embed"], step["token"])
        new = {k: torch.empty_like(cache[k])
               for k in ("ssm", "conv_x", "conv_B", "conv_C")}
        for l in range(cfg.n_layers):
            ln, lp = _layer(params, l)
            y, st, conv = S.ssd_decode_step(
                L.rms_norm(x, ln, cfg.rms_eps), lp, cfg, cache["ssm"][l],
                {k: cache[f"conv_{k}"][l] for k in ("x", "B", "C")})
            new["ssm"][l] = st
            for k in ("x", "B", "C"):
                new[f"conv_{k}"][l] = conv[k]
            x = x + y
        new["pos"] = cache["pos"] + 1
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _logits(x[:, -1], params["embed"]), new

    def init_cache(batch_size: int, device="cuda"):
        one = S.init_ssm_cache(cfg, batch_size, device=device)
        cache = {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype, device=device)
                 for k, v in one.items()}
        cache["pos"] = torch.tensor(0, dtype=torch.int32, device=device)
        return cache

    return ModelBundle(cfg, init, forward, prefill, decode_step, init_cache)
