"""Training step and loss for the model bundles (port of
``repro.training.train_loop``).

``make_train_step(bundle, opt)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``. Loss = next-token cross-entropy (padded
vocabulary columns are never targets but stay in the log-sum-exp, as in the
reference) + the router's load-balance aux for MoE configs. Gradients come
from autograd through the bundle's ``forward`` (per-layer recompute, the
attention and expert kernels' ``autograd.Function``s on the card). The
parameters are updated in place (``training/optimizer.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.model import ModelBundle
from repro_torch.training.optimizer import AdamW, tree_leaves, tree_map, tree_unflatten


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE in f32. logits: [B,S,Vp]; tokens: [B,S]. The
    log-sum-exp runs over all Vp columns (``F.cross_entropy`` on the first
    ``vocab`` would differ)."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    return (lse - picked).mean()


def make_loss_fn(bundle: ModelBundle):
    aux_w = bundle.cfg.router_aux_loss if bundle.cfg.is_moe else 0.0

    def loss_fn(params, batch):
        logits, aux = bundle.forward(params, batch)
        ce = lm_loss(logits, batch["tokens"])
        return ce + aux_w * aux, {"ce": ce, "aux": torch.as_tensor(aux)}

    return loss_fn


def _grads(loss_fn, params, batch):
    """(loss, parts, grads tree) by autograd; the params are leaves that
    require grad only for the duration of the call."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, parts = loss_fn(params, batch)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = tree_unflatten(params, [torch.zeros_like(p) if gi is None else gi
                                    for gi, p in zip(g, leaves)])
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(bundle: ModelBundle, opt: AdamW, microbatches: int = 1):
    """``microbatches > 1`` splits the batch along B and accumulates the
    gradients in f32 (the reference's ``lax.scan`` of micro-steps): the
    activations of one microbatch at a time, plus the f32 accumulator."""
    loss_fn = make_loss_fn(bundle)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, parts, grads = _grads(loss_fn, params, batch)
        else:
            micro = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = aux = 0.0
            for i in range(microbatches):
                l, parts, g = _grads(loss_fn, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                del g
                loss, aux = loss + l, aux + parts["aux"]
            inv = 1.0 / microbatches
            for acc in tree_leaves(grads):
                acc.mul_(inv)
            loss = loss * inv
            parts = {"ce": loss, "aux": aux * inv}
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **parts}

    return train_step


def make_eval_step(bundle: ModelBundle):
    loss_fn = make_loss_fn(bundle)

    def eval_step(params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step
