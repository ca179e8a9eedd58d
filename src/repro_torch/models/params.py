"""MoE-family parameters (port of the MoE branch of ``repro.models.model``).

``init_params`` builds the tree ``build(cfg).init`` builds for a uniform MoE
stack — same keys, shapes, dtypes, scales, zero norms — from a
``torch.Generator``; ``params_from_jax`` carries a JAX parameter tree across
(as numpy arrays) so both packages can be held against each other on the
same weights.

Placement: the routed-expert slabs (``layers.moe.w1/w3/w2``) live in host
memory, pinned when ``device`` is CUDA — the engine streams them to the card
through its expert cache and never keeps them there. Everything else lives
on ``device``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.moe_layer import n_experts_padded

_HOST_KEYS = ("w1", "w3", "w2")


def attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.qk_norm, cfg.qkv_bias, cfg.rope_theta, cfg.rms_eps)


def _check_moe(cfg: ArchConfig) -> None:
    if not (cfg.is_moe and cfg.n_dense_layers == 0):
        raise ValueError(f"{cfg.name}: the port builds uniform MoE stacks only")


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict:
    """Random MoE-family params: normal(0, 1) * fan_in**-0.5 weights, zero
    norms (the ``(1 + w)`` RMSNorm scale), f32 router. Draws on ``device``
    so the expert slabs are generated on the card and copied once into
    pinned host memory."""
    _check_moe(cfg)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n_l, d, H, Hkv, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd)
    ep, de = n_experts_padded(cfg), cfg.d_expert
    vp = L.vocab_pad_of(cfg.vocab)
    pin = device.type == "cuda"

    def normal(shape, scale, dtype=L.PDT):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=L.PDT, device=device)

    attn = {"wq": normal((n_l, d, H * hd), d ** -0.5),
            "wk": normal((n_l, d, Hkv * hd), d ** -0.5),
            "wv": normal((n_l, d, Hkv * hd), d ** -0.5),
            "wo": normal((n_l, H * hd, d), (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(n_l, H * hd), bk=zeros(n_l, Hkv * hd),
                    bv=zeros(n_l, Hkv * hd))
    if cfg.qk_norm:
        attn.update(q_norm=zeros(n_l, hd), k_norm=zeros(n_l, hd))
    moe = {"router": normal((n_l, d, ep), d ** -0.5, torch.float32)}
    for name, shape, scale in (("w1", (d, de), d ** -0.5),
                               ("w3", (d, de), d ** -0.5),
                               ("w2", (de, d), de ** -0.5)):
        host = torch.empty((n_l, ep) + shape, dtype=L.PDT, pin_memory=pin)
        for l in range(n_l):
            for e in range(ep):   # one slab at a time bounds device scratch
                host[l, e].copy_(normal(shape, scale))
        moe[name] = host
    if cfg.n_shared_experts:
        sh = cfg.n_shared_experts * de
        moe.update(sw1=normal((n_l, d, sh), d ** -0.5),
                   sw3=normal((n_l, d, sh), d ** -0.5),
                   sw2=normal((n_l, sh, d), sh ** -0.5))
    return {
        "embed": normal((vp, d), d ** -0.5),
        "ln_f": zeros(d),
        "layers": {"ln1": zeros(n_l, d), "attn": attn, "ln2": zeros(n_l, d),
                   "moe": moe},
    }


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: JAX hands out read-only
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda") -> Dict:
    """Carry a JAX MoE param tree (leaves as numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, params)``) across into the port's layout:
    ``layers.moe`` w1/w3 ``[L,E,d,de]``, w2 ``[L,E,de,d]``, router
    ``[L,d,E_pad]`` f32 — the same layout the reference uses."""
    device = torch.device(device)

    def conv(node, host: bool):
        if isinstance(node, dict):
            return {k: conv(v, host) for k, v in node.items()}
        t = _tensor(np.asarray(node))
        if host:
            return t.pin_memory() if device.type == "cuda" else t.clone()
        return t.to(device)

    out = {k: conv(v, False) for k, v in tree.items() if k != "layers"}
    lp = tree["layers"]
    out["layers"] = {k: conv(v, False) for k, v in lp.items() if k != "moe"}
    out["layers"]["moe"] = {k: conv(v, k in _HOST_KEYS)
                            for k, v in lp["moe"].items()}
    return out
