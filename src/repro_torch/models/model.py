"""Model bundles (port of ``repro.models.model``), for the ssm family.

``build(cfg)`` gives the reference's entry points:

  * ``init(seed, device)``           -> params (``models/params.py``)
  * ``forward(params, batch)``       -> (logits [B,S,Vp], aux) — teacher-forced
  * ``prefill(params, batch)``       -> (last_logits [B,Vp], cache)
  * ``decode_step(params, step, cache)`` -> (logits [B,Vp], cache)
  * ``init_cache(batch_size)``       -> an empty cache

``batch`` = {'tokens': [B,S]}, ``step`` = {'token': [B,1]}, int tensors on
the params' device. Layers run in a Python loop (the reference's
``lax.scan``). The cache has the reference's layout: ``ssm [L,B,h,n,p]``
f32, ``conv_x/B/C [L,B,C,K]`` bf16 and ``pos``; ``decode_step`` returns a
new cache and leaves its argument as it was.

The MoE family is served by ``serving/engine.py``, not through a bundle;
the other families are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import init_params


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
    init_cache: Callable   # (batch_size) -> cache


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "ssm":
        return build_ssm(cfg)
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the MoE family is served by serving/engine.py; its "
            "model bundle comes with ROADMAP Queue A5")
    where = "A6" if cfg.family == "hybrid" else "A5"
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP Queue {where})")


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
