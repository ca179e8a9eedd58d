"""MoE router (port of ``repro.models.moe_layer.route`` and
``n_experts_padded``). The serving engine runs the experts themselves
(serving/engine.py), so only the gate lives here."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def n_experts_padded(cfg: ArchConfig, n_model: int = 16) -> int:
    """Expert count padded to a multiple of the model axis when it exceeds
    it (qwen2-moe: 60 -> 64); the pad experts can never be selected."""
    e = cfg.n_experts
    if e >= n_model and e % n_model:
        return -(-e // n_model) * n_model
    return e


def route(x2d: torch.Tensor, router: torch.Tensor, n_real: int, top_k: int):
    """Router: returns (weights [T,k] f32, ids [T,k] int64, probs [T,E] f32).

    f32 logits (``linear``: a row's logits do not depend on the rows beside
    it) and softmax, pad experts masked to -1e9, top-k renormalised.
    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort keeps equal probabilities in index order."""
    logits = L.linear(x2d.float(), router)              # [T, E_pad]
    e_pad = router.shape[1]
    if e_pad > n_real:
        pad = torch.arange(e_pad, device=logits.device) >= n_real
        logits = logits.masked_fill(pad[None], -1e9)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids, probs
