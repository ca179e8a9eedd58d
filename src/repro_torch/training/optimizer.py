"""AdamW with the reference's own update (port of
``repro.training.optimizer.AdamW``).

It differs from ``torch.optim.AdamW``'s defaults, so the port carries the
update itself: b2 = 0.95, a global-norm gradient clip before the moments,
f32 moments whatever the parameter dtype, and weight decay added to the
update of matrices only (norms and biases exempt).
"""
from __future__ import annotations

from typing import Iterable, List

import torch


class AdamW:
    def __init__(self, params: Iterable[torch.Tensor], lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.step_count = 0
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``; returns the
        global gradient norm (before clipping)."""
        self.step_count += 1
        grads = [p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p in self.params]
        gn = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(self.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        bc1 = 1 - self.b1 ** self.step_count
        bc2 = 1 - self.b2 ** self.step_count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.ndim >= 2:
                u = u + self.weight_decay * p.float()
            p.copy_((p.float() - self.lr * u).to(p.dtype))
        return gn
