"""Model parameters (port of the ``init`` of ``repro.models.model``'s bundles).

``init_params`` builds the tree ``build(cfg).init`` builds — same keys,
shapes, dtypes, scales, zero norms — from a ``torch.Generator``, for the two
families the port serves: a uniform MoE stack and the ssm family (Mamba2).
``params_from_jax`` carries a JAX parameter tree of either across (as numpy
arrays) so both packages can be held against each other on the same weights.

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
from repro_torch.models.ssm import ssm_param_shapes

_HOST_KEYS = ("w1", "w3", "w2")


def attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.qk_norm, cfg.qkv_bias, cfg.rope_theta, cfg.rms_eps)


def _check_family(cfg: ArchConfig) -> None:
    """The port builds uniform MoE stacks and the ssm family; the other
    families are ROADMAP Queue A5 (the hybrid family A6)."""
    if cfg.family == "ssm" or (cfg.is_moe and cfg.n_dense_layers == 0):
        return
    raise NotImplementedError(
        f"{cfg.name}: the port builds uniform MoE stacks and the ssm family "
        f"only (family {cfg.family!r}: ROADMAP Queue A5/A6)")


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict:
    """Random params: normal(0, 1) * fan_in**-0.5 weights, zero norms (the
    ``(1 + w)`` RMSNorm scale), the reference's f32 leaves (MoE router; SSM
    A_log, D, dt_bias). Draws on ``device``, so MoE expert slabs are
    generated on the card and copied once into pinned host memory."""
    _check_family(cfg)
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "ssm":
        return _init_ssm(cfg, g, device)
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
    # w1, w3 and w2 are views of ONE host buffer: PyTorch's caching host
    # allocator rounds each pinned allocation up to a power of two and keeps
    # it when freed (ATen/core/CachingHostAllocator.h), so three buffers of
    # 10.3 GB (DeepSeekMoE-16B) would pin 3 x 16 GiB where one pins 32 GiB
    n = n_l * ep * d * de
    host = torch.empty(3 * n, dtype=L.PDT, pin_memory=pin)
    for i, (name, shape, scale) in enumerate((("w1", (d, de), d ** -0.5),
                                              ("w3", (d, de), d ** -0.5),
                                              ("w2", (de, d), de ** -0.5))):
        slabs = host[i * n:(i + 1) * n].view((n_l, ep) + shape)
        for l in range(n_l):
            for e in range(ep):   # one slab at a time bounds device scratch
                slabs[l, e].copy_(normal(shape, scale))
        moe[name] = slabs
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


def _init_ssm(cfg: ArchConfig, g: torch.Generator, device) -> Dict:
    """Mamba2 params, stacked over layers: ``layers.ln`` and ``layers.ssm``
    (``ssm_param_shapes``), as ``build_ssm(cfg).init`` builds them."""
    n_l, d = cfg.n_layers, cfg.d_model
    vp = L.vocab_pad_of(cfg.vocab)

    def make(shape, dtype, init, scale):
        if init == "normal":
            return (torch.randn(shape, generator=g, device=device)
                    * scale).to(dtype)
        fill = {"zeros": 0.0, "ones": 1.0, "full": scale}[init]
        return torch.full(shape, fill, dtype=dtype, device=device)

    ssm = {k: make((n_l,) + shape, dtype, init, scale)
           for k, (shape, dtype, init, scale) in ssm_param_shapes(cfg).items()}
    return {
        "embed": make((vp, d), L.PDT, "normal", d ** -0.5),
        "ln_f": make((d,), L.PDT, "zeros", None),
        "layers": {"ln": make((n_l, d), L.PDT, "zeros", None), "ssm": ssm},
    }


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: JAX hands out read-only
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda") -> Dict:
    """Carry a JAX param tree (leaves as numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, params)``) across into the port, keys and
    layouts unchanged: for MoE ``layers.moe`` w1/w3 ``[L,E,d,de]``, w2
    ``[L,E,de,d]``, router ``[L,d,E_pad]`` f32; for the ssm family
    ``layers.ssm`` stacked over layers. Only the expert slabs go to the
    host; every other leaf to ``device``."""
    device = torch.device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        t = _tensor(np.asarray(node))
        if path[:2] == ("layers", "moe") and path[-1] in _HOST_KEYS:
            return t.pin_memory() if device.type == "cuda" else t.clone()
        return t.to(device)

    return conv(dict(tree), ())
