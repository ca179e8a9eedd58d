"""ExpertMLP (paper §IV-B): the expert-activation predictor, on PyTorch.

Port of ``repro.core.predictor``. Seven fully-connected hidden layers
(2048 down to 64, scaled by ``width_scale``), each followed by BatchNorm,
ReLU and Dropout(0.1), then a linear output over the target layer's experts;
trained with multi-label binary cross-entropy (Eq. 6).

BatchNorm is the reference's own, not ``nn.BatchNorm1d``: the running
statistics keep ``momentum * old + (1 - momentum) * batch`` with momentum
0.9, the batch variance is the population variance plus 1e-5 (and that sum
is what the running variance tracks), and evaluation adds 1e-5 again.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import upload
from repro_torch.training.optimizer import AdamW

HIDDEN = (2048, 1536, 1024, 512, 256, 128, 64)
DROPOUT = 0.1
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def hidden_dims(width_scale: float = 1.0) -> Tuple[int, ...]:
    return tuple(max(8, int(h * width_scale)) for h in HIDDEN)


class _BatchNorm(nn.Module):
    def __init__(self, n: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer("mean", torch.zeros(n, device=device))
        self.register_buffer("var", torch.ones(n, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.training:
            mu = h.mean(0)
            var = h.var(0, unbiased=False) + BN_EPS
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
                self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mu, var = self.mean, self.var + BN_EPS
        return (h - mu) * torch.rsqrt(var) * self.scale + self.bias


class ExpertMLP(nn.Module):
    """dims: (in_dim, *hidden widths, n_experts) — see ``hidden_dims``."""

    def __init__(self, dims: Sequence[int], *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.linears = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(len(dims) - 1):
            lin = nn.Linear(dims[i], dims[i + 1], device=device)
            with torch.no_grad():   # the reference's init: N(0, 2/fan_in), b = 0
                lin.weight.copy_(torch.randn(dims[i + 1], dims[i],
                                             generator=generator, device=device)
                                 * (2.0 / dims[i]) ** 0.5)
                lin.bias.zero_()
            self.linears.append(lin)
            if i < len(dims) - 2:
                self.norms.append(_BatchNorm(dims[i + 1], device=device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, E]. Dropout applies in training mode when a generator
        is given (the reference drops only when handed an rng)."""
        h = x
        for i, lin in enumerate(self.linears):
            h = lin(h)
            if i < len(self.norms):
                h = torch.relu(self.norms[i](h))
                if self.training and generator is not None:
                    keep = torch.bernoulli(torch.full_like(h, 1 - DROPOUT),
                                           generator=generator)
                    h = torch.where(keep > 0, h / (1 - DROPOUT), 0.0)
        return h

    @classmethod
    def from_jax(cls, params: Sequence[Dict], bn_state: Sequence[Dict],
                 device="cuda") -> "ExpertMLP":
        """Carry the reference's (params, bn_state) lists across; leaves are
        numpy arrays, weights in the reference's [in, out] layout."""
        dims = [np.shape(params[0]["w"])[0]] + [np.shape(p["w"])[1] for p in params]
        model = cls(dims, device=device)
        t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32),
                                      device=device)
        with torch.no_grad():
            for i, p in enumerate(params):
                model.linears[i].weight.copy_(t(p["w"]).T)
                model.linears[i].bias.copy_(t(p["b"]))
                if i < len(model.norms):
                    bn = model.norms[i]
                    bn.scale.copy_(t(p["bn_scale"]))
                    bn.bias.copy_(t(p["bn_bias"]))
                    bn.mean.copy_(t(bn_state[i]["mean"]))
                    bn.var.copy_(t(bn_state[i]["var"]))
        return model

    def reference_tree(self):
        """(params, bn_state) in the reference's layout, the inverse of
        ``from_jax``: per layer {"w" [in, out], "b", "bn_scale", "bn_bias"},
        per hidden layer {"mean", "var"}, as f32 numpy arrays."""
        f = lambda t: t.detach().float().cpu().numpy()
        params, bn_state = [], []
        for i, lin in enumerate(self.linears):
            params.append({"w": f(lin.weight).T.copy(), "b": f(lin.bias)})
            if i < len(self.norms):
                bn = self.norms[i]
                params[-1].update(bn_scale=f(bn.scale), bn_bias=f(bn.bias))
                bn_state.append({"mean": f(bn.mean), "var": f(bn.var)})
        return params, bn_state


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Eq. 6: multi-label binary cross-entropy over sigmoid outputs, in the
    stable form max(z,0) - z*y + log(1+exp(-|z|))."""
    z = logits
    return torch.mean(torch.clamp(z, min=0) - z * targets
                      + torch.log1p(torch.exp(-torch.abs(z))))


@dataclasses.dataclass
class TrainedPredictor:
    model: ExpertMLP
    top_k: int

    @torch.no_grad()
    def predict_logits(self, x: np.ndarray) -> np.ndarray:
        self.model.eval()
        dev = next(self.model.parameters()).device
        lg = self.model(upload(x, dev, torch.float32))
        return lg.cpu().numpy()

    def predict_topk(self, x: np.ndarray, k: Optional[int] = None) -> np.ndarray:
        lg = self.predict_logits(x)
        k = k or self.top_k
        return np.argsort(-lg, axis=-1)[..., :k]


def train_predictor(seed: int, X: np.ndarray, Y: np.ndarray, top_k: int, *,
                    width_scale: float = 1.0, epochs: int = 10,
                    batch: int = 256, lr: float = 1e-3,
                    val_frac: float = 0.1, verbose: bool = False,
                    device="cuda"):
    """Offline preprocess training (paper §IV-B). The split and the batch
    order come from ``numpy.random.default_rng(0)`` as in the reference;
    the init and dropout draws from a ``torch.Generator`` seeded with
    ``seed``. Returns (TrainedPredictor, history dict)."""
    device = torch.device(device)
    n = X.shape[0]
    n_val = max(1, int(n * val_frac))
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    Xtr, Ytr = X[perm[n_val:]], Y[perm[n_val:]]
    Xva, Yva = X[perm[:n_val]], Y[perm[:n_val]]

    g = torch.Generator(device=device).manual_seed(seed)
    dims = (X.shape[1],) + hidden_dims(width_scale) + (Y.shape[1],)
    model = ExpertMLP(dims, generator=g, device=device)
    opt = AdamW(model.parameters(), lr=lr, weight_decay=1e-4, grad_clip=1.0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    Xtr_t, Ytr_t = t(Xtr), t(Ytr)

    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                       "val_topk": [], "val_half": []}
    steps_per_epoch = max(1, len(Xtr) // batch)
    for ep in range(epochs):
        perm = rng.permutation(len(Xtr))
        losses = []
        model.train()
        for i in range(steps_per_epoch):
            idx = torch.as_tensor(perm[i * batch:(i + 1) * batch], device=device)
            loss = bce_loss(model(Xtr_t[idx], generator=g), Ytr_t[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        model.eval()
        with torch.no_grad():
            vlg = model(t(Xva))
            vl = float(bce_loss(vlg, t(Yva)))
        tk, half = accuracy_metrics(vlg.cpu().numpy(), Yva, top_k)
        history["train_loss"].append(float(torch.stack(losses).mean()))
        history["val_loss"].append(vl)
        history["val_topk"].append(tk)
        history["val_half"].append(half)
        if verbose:
            print(f"epoch {ep}: train {history['train_loss'][-1]:.4f} "
                  f"val {vl:.4f} topk {tk:.3f} half {half:.3f}")
    return TrainedPredictor(model, top_k), history


def accuracy_metrics(logits: np.ndarray, targets: np.ndarray,
                     top_k: int) -> Tuple[float, float]:
    """Paper Table III metrics: top-k exact (all routed experts predicted)
    and at-least-half (>= ceil(k/2) of them in the predicted top-k)."""
    pred = np.argsort(-logits, axis=-1)[:, :top_k]
    hits = np.zeros(len(logits))
    for i in range(len(logits)):
        true = np.where(targets[i] > 0)[0]
        hits[i] = len(np.intersect1d(pred[i], true))
    k_true = targets.sum(1)
    exact = float(np.mean(hits >= k_true))
    half = float(np.mean(hits >= np.ceil(k_true / 2)))
    return exact, half
