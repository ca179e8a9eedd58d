"""Training step and loss for the model bundles (port of
``repro.training.train_loop``).

``make_train_step(bundle, opt)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``. Loss = next-token cross-entropy (padded
vocabulary columns are never targets but stay in the log-sum-exp, as in the
reference) + the router's load-balance aux for MoE configs. Gradients come
from autograd through the bundle's ``forward`` (per-layer recompute, the
attention and expert kernels' ``autograd.Function``s on the card). The
parameters are updated in place (``training/optimizer.py``).

On a mesh (a bundle built with ``mesh_info``, an optimizer wrapped in
``ZeRO1``) each rank runs its data shard; where the logits are the rank's
vocabulary block the loss is the vocab-parallel cross entropy
(``vocab_parallel_lm_loss``: max and sum of exponentials over the model
axis, never the whole logits). After each microbatch's backward each
gradient leaf is reduce-scattered over the data axes in f32 into its ZeRO
slice (all-reduced where its moments are whole), so the f32 accumulator
holds only this rank's slices (the reference's ``acc_constraint``); the
step then averages it and updates the slices. Under FSDP
(``mesh_info["fsdp"]``) the params are those slices and their gradients
arrive summed and sliced by the forward's gathers
(``collectives.gather_params``, rounded to the leaf's dtype), so
``ZeRO1.reduce`` only casts them to f32; each microbatch's forward gathers
the layers again, as the reference's lowered scan does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import collectives as C
from repro_torch.models.layers import vocab_pad_of
from repro_torch.models.model import ModelBundle
from repro_torch.training.optimizer import ZeRO1, tree_leaves, tree_unflatten

# elements of one block of rows of the vocab-parallel loss's f32 work
CE_BLOCK_ELEMS = 1 << 26


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE in f32. logits: [B,S,Vp]; tokens: [B,S]. The
    log-sum-exp runs over all Vp columns (``F.cross_entropy`` on the first
    ``vocab`` would differ)."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    return (lse - picked).mean()


def _row_blocks(logits: torch.Tensor):
    """(b, r0, r1) blocks of the rows 0 .. S-2 of each sequence of
    ``logits`` [B,S,V], at most ``CE_BLOCK_ELEMS`` entries each."""
    B, S, V = logits.shape
    rows = max(1, CE_BLOCK_ELEMS // V)
    for b in range(B):
        for r0 in range(0, S - 1, rows):
            yield b, r0, min(S - 1, r0 + rows)


class _VocabParallelCE(torch.autograd.Function):
    """``lm_loss`` over logits whose last dim is this rank's block of the
    padded vocabulary, ``tp.index``-th of ``tp.size``: the row max and the
    sum of exponentials and the target's logit are reduced over the model
    axis (three all-reduces of [B, S-1]); the backward is each block's
    (softmax - one-hot) / N, recomputed from the bf16 logits and the lse a
    block of rows at a time, so no [B, S, V] f32 tensor is ever held."""

    @staticmethod
    def forward(ctx, logits, tokens, tp):
        B, S, V = logits.shape
        loc = tokens[:, 1:].long() - tp.index * V
        hit = (loc >= 0) & (loc < V)
        m = torch.empty((B, S - 1), dtype=torch.float32, device=logits.device)
        for b, r0, r1 in _row_blocks(logits):
            m[b, r0:r1] = logits[b, r0:r1].float().amax(-1)
        m = C.pmax(m, tp)
        s = torch.empty_like(m)
        for b, r0, r1 in _row_blocks(logits):
            s[b, r0:r1] = (logits[b, r0:r1].float() - m[b, r0:r1, None]).exp().sum(-1)
        s = C.psum(s, tp)
        picked = torch.gather(logits[:, :-1], 2, loc.clamp(0, V - 1)[..., None])[..., 0]
        picked = C.psum(torch.where(hit, picked.float(), 0.0), tp)
        lse = m + torch.log(s)
        ctx.save_for_backward(logits, lse, loc, hit)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, lse, loc, hit = ctx.saved_tensors
        B, S, V = logits.shape
        scale = g / (B * (S - 1))
        grad = torch.zeros_like(logits)
        for b, r0, r1 in _row_blocks(logits):
            p = (logits[b, r0:r1].float() - lse[b, r0:r1, None]).exp()
            rows = hit[b, r0:r1].nonzero()[:, 0]
            p[rows, loc[b, r0:r1][rows]] -= 1.0
            grad[b, r0:r1] = (p * scale).to(logits.dtype)
        return grad, None, None


def vocab_parallel_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, tp: C.Axis):
    """``lm_loss`` of vocab-sharded logits [B,S,Vp/n] (this rank's block)."""
    return _VocabParallelCE.apply(logits, tokens, tp)


def make_loss_fn(bundle: ModelBundle):
    aux_w = bundle.cfg.router_aux_loss if bundle.cfg.is_moe else 0.0
    mesh_info = bundle.mesh_info
    tp = mesh_info["mesh"].axis(mesh_info["tp"]) if mesh_info else None
    vp = vocab_pad_of(bundle.cfg.vocab)

    def loss_fn(params, batch):
        logits, aux = bundle.forward(params, batch)
        if tp is not None and logits.shape[-1] < vp:
            ce = vocab_parallel_lm_loss(logits, batch["tokens"], tp)
        else:
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


def make_train_step(bundle: ModelBundle, opt, microbatches: int = 1):
    """``microbatches > 1`` splits the batch along B and accumulates the
    gradients in f32 (the reference's ``lax.scan`` of micro-steps): the
    activations of one microbatch at a time, plus the f32 accumulator.

    On a mesh (a bundle built with ``mesh_info``) ``opt`` is a ``ZeRO1``,
    ``batch`` the rank's data shard and ``params`` its blocks; the
    gradients are accumulated as ``ZeRO1.reduce``'s slices and the metrics
    are the whole batch's (averaged over the data axes)."""
    loss_fn = make_loss_fn(bundle)
    zero = None
    if bundle.mesh_info is not None:
        if not isinstance(opt, ZeRO1):
            raise TypeError("on a mesh the optimizer is a ZeRO1")
        zero = opt

    def train_step(params, opt_state, batch):
        if zero is None and microbatches == 1:
            loss, parts, grads = _grads(loss_fn, params, batch)
        else:
            loss, parts, grads = _accumulate(loss_fn, params, batch, microbatches, zero)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **parts}

    return train_step


def _micro(batch, microbatches: int):
    return {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
            for k, v in batch.items()}


def _accumulate(loss_fn, params, batch, microbatches: int, zero: Optional[ZeRO1]):
    """(loss, parts, grads) as ``_grads`` gives them, each the mean over
    the microbatches and, on a mesh (``zero``), over the data axes; grads
    in f32, on a mesh this rank's ZeRO slices. Each gradient leaf is
    reduced (cast to f32, or ``ZeRO1.reduce``) and added to the accumulator
    before the next one is, and its bf16 gradient dropped, so one full f32
    leaf at a time is alive beside the accumulator. ``parts["ce"]`` is the
    loss when there are microbatches, as the reference's scan reports it."""
    micro = _micro(batch, microbatches)
    reduce = zero.reduce if zero is not None else lambda g, j: g.float()
    acc: list = []
    loss = ce = aux = 0.0
    for i in range(microbatches):
        l, parts, g = _grads(loss_fn, params, {k: v[i] for k, v in micro.items()})
        leaves = tree_leaves(g)
        del g
        for j in range(len(leaves)):
            r = reduce(leaves[j], j)
            leaves[j] = None
            if i == 0:
                acc.append(r)
            else:
                acc[j].add_(r)
            del r
        loss, ce, aux = loss + l, ce + parts["ce"], aux + parts["aux"]
    n = microbatches
    if zero is not None:
        n *= zero.dp.size
        loss, ce, aux = C.psum(torch.stack([torch.as_tensor(t, dtype=torch.float32,
                                                            device=l.device).reshape(())
                                            for t in (loss, ce, aux)]), zero.dp)
    inv = 1.0 / n
    for a in acc:
        a.mul_(inv)
    return loss * inv, {"ce": (ce if microbatches == 1 else loss) * inv,
                        "aux": aux * inv}, tree_unflatten(params, acc)


def make_eval_step(bundle: ModelBundle):
    loss_fn = make_loss_fn(bundle)

    def eval_step(params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step
