"""Model parameters (port of the ``init`` of ``repro.models.model``'s bundles).

``init_params`` builds the tree ``build(cfg).init`` builds — same keys,
shapes, dtypes, scales, zero norms — from a ``torch.Generator``, for the
families the port builds: ``build_dense``'s (dense stacks, MoE stacks and
the ``dense0`` stack of leading dense layers) and the ssm family (Mamba2).
``params_from_jax`` carries a JAX parameter tree of any of them across (as
numpy arrays) so both packages can be held against each other on the same
weights.

Placement of the routed-expert slabs (``layers.moe.w1/w3/w2``):
``expert_slabs="host"`` (the serving engines' default) keeps them in host
memory, pinned when ``device`` is CUDA — the engines stream them to the card
through their expert cache and never keep them there; ``"device"`` (the
model bundles, which run every expert) puts them on ``device`` with the
rest. Everything else lives on ``device``. A seed draws the same values
under either placement.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.moe_layer import moe_params, n_experts_padded
from repro_torch.models.ssm import ssm_param_shapes

_SLAB_KEYS = ("w1", "w3", "w2")
PLACEMENTS = ("host", "device")


def attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.qk_norm, cfg.qkv_bias, cfg.rope_theta, cfg.rms_eps)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                expert_slabs: str = "host") -> Dict:
    """Random params: normal(0, 1) * fan_in**-0.5 weights, zero norms (the
    ``(1 + w)`` RMSNorm scale), the reference's f32 leaves (MoE router; SSM
    A_log, D, dt_bias). Draws on ``device``, one expert slab at a time, so
    host slabs are generated on the card and copied once into pinned
    memory."""
    if expert_slabs not in PLACEMENTS:
        raise ValueError(f"expert_slabs must be one of {PLACEMENTS}")
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "ssm":
        return _init_ssm(cfg, g, device)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP Queue A)")
    return _init_dense(cfg, g, device, expert_slabs)


def _init_dense(cfg: ArchConfig, g: torch.Generator, device, expert_slabs: str) -> Dict:
    """``build_dense``'s tree. Draw order: each stack's attention, then its
    FFN (``layers``, then ``dense0``), the embedding last."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_dense = cfg.n_dense_layers
    n_scan = cfg.n_layers - n_dense

    def normal(shape, scale, dtype=L.PDT):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=L.PDT, device=device)

    def attn(n):
        p = {"wq": normal((n, d, H * hd), d ** -0.5),
             "wk": normal((n, d, Hkv * hd), d ** -0.5),
             "wv": normal((n, d, Hkv * hd), d ** -0.5),
             "wo": normal((n, H * hd, d), (H * hd) ** -0.5)}
        if cfg.qkv_bias:
            p.update(bq=zeros(n, H * hd), bk=zeros(n, Hkv * hd), bv=zeros(n, Hkv * hd))
        if cfg.qk_norm:
            p.update(q_norm=zeros(n, hd), k_norm=zeros(n, hd))
        return p

    def mlp(n, ff):
        return {"w1": normal((n, d, ff), d ** -0.5), "w3": normal((n, d, ff), d ** -0.5),
                "w2": normal((n, ff, d), ff ** -0.5)}

    def block(n, ffn_key, ffn):
        return {"ln1": zeros(n, d), "attn": attn(n), "ln2": zeros(n, d), ffn_key: ffn(n)}

    if cfg.is_moe:
        layers = block(n_scan, "moe", lambda n: moe_params(
            cfg, normal, n, _host_slabs(cfg, n, device) if expert_slabs == "host" else None))
    else:
        layers = block(n_scan, "mlp", lambda n: mlp(n, cfg.d_ff))
    p = {"layers": layers}
    if n_dense:
        p["dense0"] = block(n_dense, "mlp", lambda n: mlp(n, cfg.dense_d_ff))
    p["embed"] = normal((L.vocab_pad_of(cfg.vocab), d), d ** -0.5)
    p["ln_f"] = zeros(d)
    return p


def _host_slabs(cfg: ArchConfig, n: int, device) -> Dict:
    """w1, w3 and w2 of n layers as views of ONE host buffer, pinned for a
    CUDA ``device``: PyTorch's caching host allocator rounds each pinned
    allocation up to a power of two and keeps it when freed
    (ATen/core/CachingHostAllocator.h), so three buffers of 10.3 GB
    (DeepSeekMoE-16B) would pin 3 x 16 GiB where one pins 32 GiB."""
    d, de, ep = cfg.d_model, cfg.d_expert, n_experts_padded(cfg)
    m = n * ep * d * de
    host = torch.empty(3 * m, dtype=L.PDT, pin_memory=torch.device(device).type == "cuda")
    return {name: host[i * m:(i + 1) * m].view((n, ep) + shape)
            for i, (name, shape) in enumerate((("w1", (d, de)), ("w3", (d, de)),
                                               ("w2", (de, d))))}


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


def params_from_jax(tree, device="cuda", expert_slabs: str = "host") -> Dict:
    """Carry a JAX param tree (leaves as numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, params)``) across into the port, keys and
    layouts unchanged: for MoE ``layers.moe`` w1/w3 ``[L,E,d,de]``, w2
    ``[L,E,de,d]``, router ``[L,d,E_pad]`` f32, ``dense0`` and dense
    ``layers.mlp`` as ``build_dense`` stacks them; for the ssm family
    ``layers.ssm`` stacked over layers. The expert slabs go where
    ``expert_slabs`` says (module docstring); every other leaf to
    ``device``."""
    if expert_slabs not in PLACEMENTS:
        raise ValueError(f"expert_slabs must be one of {PLACEMENTS}")
    device = torch.device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        t = _tensor(np.asarray(node))
        if (expert_slabs == "host" and path[:2] == ("layers", "moe")
                and path[-1] in _SLAB_KEYS):
            return t.pin_memory() if device.type == "cuda" else t.clone()
        return t.to(device)

    return conv(dict(tree), ())
