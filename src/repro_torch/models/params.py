"""Model parameters (port of the ``init`` of ``repro.models.model``'s bundles).

``init_params`` builds the tree ``build(cfg).init`` builds — same keys,
shapes, dtypes, scales, zero norms — from a ``torch.Generator``, for every
family: ``build_dense``'s (dense stacks, MoE stacks and the ``dense0``
stack of leading dense layers), the ssm family (Mamba2), the hybrid
(``mamba`` [n_blocks, per], ``shared``, ``tail``), the vlm
(``blocks.self`` [n_blocks, n_self], ``blocks.cross``, ``proj``) and the
enc-dec (``enc``, ``ln_enc``, ``dec`` with ``ln_x`` / ``xattn``, ``proj``);
``pattern_params`` cuts ``build_dense_pattern``'s tree (``blocks``
[n_pat, per], ``tail``) out of a dense one as views. ``params_from_jax``
carries a JAX parameter tree of any of them across (as numpy arrays) so
both packages can be held against each other on the same weights.
``shard_params`` cuts a rank's blocks out of a tree by its partition specs
(``launch/partition.py``): drawn whole from a seed and then cut, each
rank's shard equals the slice of the tree one device draws from that seed.

Placement of the routed-expert slabs (``layers.moe.w1/w3/w2``):
``expert_slabs="host"`` (the serving engines' default) keeps them in host
memory, pinned when ``device`` is CUDA — the engines stream them to the card
through their expert cache and never keep them there; ``"device"`` (the
model bundles, which run every expert) puts them on ``device`` with the
rest. Everything else lives on ``device``. A seed draws the same values
under either placement.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

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
                expert_slabs: str = "host", n_model: int = 16,
                keep: Optional[Callable] = None) -> Dict:
    """Random params: normal(0, 1) * fan_in**-0.5 weights, zero norms (the
    ``(1 + w)`` RMSNorm scale), the reference's f32 leaves (MoE router; SSM
    A_log, D, dt_bias). Draws on ``device``, one expert slab at a time, so
    host slabs are generated on the card and copied once into pinned
    memory. On ``meta`` the tree's shapes and dtypes, nothing drawn. The
    routed experts are padded by ``n_model``, the mesh's model axis (the
    reference's 16 without a mesh; ``moe_layer.n_experts_padded``).
    ``keep``: a function each leaf goes through as soon as it is drawn, in
    draw order (``init_blocks``); not for an MoE config, whose expert slabs
    are drawn an expert at a time."""
    if expert_slabs not in PLACEMENTS:
        raise ValueError(f"expert_slabs must be one of {PLACEMENTS}")
    if keep is not None and cfg.is_moe:
        raise ValueError(f"{cfg.name}: an MoE tree's expert slabs are not drawn a leaf a call")
    device = torch.device(device)
    g = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    draw = _Draw(cfg, g, device, keep)
    if cfg.family == "ssm":
        return _init_ssm(draw)
    if cfg.family in ("hybrid", "vlm", "encdec"):
        return {"hybrid": _init_hybrid, "vlm": _init_vlm, "encdec": _init_encdec}[cfg.family](draw)
    return _init_dense(draw, expert_slabs, n_model)


def init_blocks(cfg: ArchConfig, seed: int, device, mesh_info: dict, **kw) -> Dict:
    """This rank's blocks of ``init_params(cfg, seed, device, **kw)`` under
    ``launch/partition.py param_specs`` on the mesh of ``mesh_info`` (under
    FSDP, ``mesh_info["fsdp"]`` the tree of each leaf's data-axis dim,
    ``partition.data_dims``: each block's slice along that dim, its
    ``zero_specs`` block), each leaf cut as soon as it is drawn (``keep``),
    so a rank holds its blocks and one whole leaf at a time, not the whole
    tree: the values are ``shard_params``' of the whole draw. The specs
    come from the tree on ``meta``, whose leaves map to the draws in draw
    order. An MoE tree is drawn whole and then cut (``init_params``'
    ``keep``)."""
    from repro_torch.launch.partition import param_specs, shard_leaf
    mesh = mesh_info["mesh"]
    n_model = mesh.shape[mesh_info["tp"]]
    dims = mesh_info.get("fsdp")

    def specs_of(tree):
        pspecs = param_specs(cfg, tree, n_model=n_model)
        return pspecs if dims is None else _data_specs(pspecs, dims, mesh_info)

    if cfg.is_moe:
        whole = init_params(cfg, seed, device, **kw)
        return shard_params(whole, specs_of(whole), mesh)
    drawn = []
    meta = init_params(cfg, seed, "meta", keep=lambda t: drawn.append(t) or t, **kw)
    spec_of = dict(zip(map(id, _leaves(meta)), _leaves(specs_of(meta))))
    specs = iter([spec_of[id(t)] for t in drawn])
    return init_params(cfg, seed, device, keep=lambda t: shard_leaf(t, next(specs), mesh), **kw)


def _data_specs(specs, dims, mesh_info: dict):
    """``specs`` (a tree of blocks' specs) with the data axes of
    ``mesh_info`` added on each leaf's dim of ``dims`` (``partition.data_dims``;
    None: none): ``zero_specs`` where ``specs`` are ``param_specs``."""
    if isinstance(specs, dict):
        return {k: _data_specs(v, dims[k], mesh_info) for k, v in specs.items()}
    if dims is None:
        return specs
    spec = tuple(specs) + (None,) * (dims + 1 - len(specs))
    return spec[:dims] + (tuple(mesh_info["dp"]),) + spec[dims + 1:]


def cut_data(tree: Dict, dims, mesh_info: dict) -> Dict:
    """This rank's slice of each leaf of ``tree`` along its data-axis dim
    (``dims``, as in ``_data_specs``)."""
    from repro_torch.launch.partition import shard_leaf

    def cut(node, d):
        if isinstance(node, dict):
            return {k: cut(v, d[k]) for k, v in node.items()}
        return node if d is None else shard_leaf(node, _data_specs((), d, mesh_info),
                                                 mesh_info["mesh"])

    return cut(tree, dims)


def _leaves(tree) -> list:
    """The leaves of a nested dict (a spec's tuple is one leaf), in order."""
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _init_dense(draw: "_Draw", expert_slabs: str, n_model: int) -> Dict:
    """``build_dense``'s tree. Draw order: each stack's attention, then its
    FFN (``layers``, then ``dense0``), the embedding last."""
    cfg, device = draw.cfg, draw.device
    n_dense = cfg.n_dense_layers
    n_scan = cfg.n_layers - n_dense
    if cfg.is_moe:
        slabs = _host_slabs(cfg, n_scan, device, n_model) if expert_slabs == "host" else None
        layers = draw.block((n_scan,), ("moe", lambda: moe_params(cfg, draw.normal, n_scan,
                                                                   slabs, n_model)))
    else:
        layers = draw.block((n_scan,))
    p = {"layers": layers}
    if n_dense:
        p["dense0"] = draw.block((n_dense,), ("mlp", lambda: draw.mlp((n_dense,),
                                                                      cfg.dense_d_ff)))
    p.update(draw.head())
    return p


def _host_slabs(cfg: ArchConfig, n: int, device, n_model: int = 16) -> Dict:
    """w1, w3 and w2 of n layers as views of ONE host buffer, pinned for a
    CUDA ``device``: PyTorch's caching host allocator rounds each pinned
    allocation up to a power of two and keeps it when freed
    (ATen/core/CachingHostAllocator.h), so three buffers of 10.3 GB
    (DeepSeekMoE-16B) would pin 3 x 16 GiB where one pins 32 GiB."""
    d, de, ep = cfg.d_model, cfg.d_expert, n_experts_padded(cfg, n_model)
    m = n * ep * d * de
    host = torch.empty(3 * m, dtype=L.PDT, pin_memory=torch.device(device).type == "cuda")
    return {name: host[i * m:(i + 1) * m].view((n, ep) + shape)
            for i, (name, shape) in enumerate((("w1", (d, de)), ("w3", (d, de)),
                                               ("w2", (de, d))))}


def _init_ssm(draw: "_Draw") -> Dict:
    """Mamba2 params, stacked over layers: ``layers.ln`` and ``layers.ssm``
    (``ssm_param_shapes``), as ``build_ssm(cfg).init`` builds them."""
    layers = draw.mamba((draw.cfg.n_layers,))
    return dict(draw.head(), layers=layers)


class _Draw:
    """The leaves of a param tree, drawn from ``g`` on ``device`` in call
    order: normal(0, 1) * scale weights (one draw per leaf), zero norms;
    each through ``keep`` where given (``init_params``)."""

    def __init__(self, cfg: ArchConfig, g: torch.Generator, device,
                 keep: Optional[Callable] = None):
        self.cfg, self.g, self.device = cfg, g, device
        self.keep = keep or (lambda t: t)

    def normal(self, shape, scale, dtype=L.PDT):
        return self.keep(torch.randn(shape, generator=self.g,
                                     device=self.device).mul_(scale).to(dtype))

    def zeros(self, shape, dtype=L.PDT):
        return self.keep(torch.zeros(shape, dtype=dtype, device=self.device))

    def attn(self, lead):
        cfg = self.cfg
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        p = {"wq": self.normal(lead + (d, H * hd), d ** -0.5),
             "wk": self.normal(lead + (d, Hkv * hd), d ** -0.5),
             "wv": self.normal(lead + (d, Hkv * hd), d ** -0.5),
             "wo": self.normal(lead + (H * hd, d), (H * hd) ** -0.5)}
        if cfg.qkv_bias:
            p.update(bq=self.zeros(lead + (H * hd,)), bk=self.zeros(lead + (Hkv * hd,)),
                     bv=self.zeros(lead + (Hkv * hd,)))
        if cfg.qk_norm:
            p.update(q_norm=self.zeros(lead + (hd,)), k_norm=self.zeros(lead + (hd,)))
        return p

    def mlp(self, lead, ff: int):
        d = self.cfg.d_model
        return {"w1": self.normal(lead + (d, ff), d ** -0.5),
                "w3": self.normal(lead + (d, ff), d ** -0.5),
                "w2": self.normal(lead + (ff, d), ff ** -0.5)}

    def block(self, lead, ffn=None):
        """A decoder block (``ln1``, ``attn``, ``ln2`` and the FFN) stacked
        over the leading dims ``lead``; ``ffn`` = (key, draw) for another FFN
        than the ``d_ff`` MLP, drawn after the attention."""
        key, ffn = ffn or ("mlp", lambda: self.mlp(lead, self.cfg.d_ff))
        d = self.cfg.d_model
        return {"ln1": self.zeros(lead + (d,)), "attn": self.attn(lead),
                "ln2": self.zeros(lead + (d,)), key: ffn()}

    def mamba(self, lead):
        """Mamba2 layers (``ln``, ``ssm``) stacked over ``lead``."""
        def make(shape, dtype, init, scale):
            if init == "normal":
                return self.normal(lead + shape, scale, dtype)
            fill = {"zeros": 0.0, "ones": 1.0, "full": scale}[init]
            return self.keep(torch.full(lead + shape, fill, dtype=dtype, device=self.device))
        return {"ln": self.zeros(lead + (self.cfg.d_model,)),
                "ssm": {k: make(*v) for k, v in ssm_param_shapes(self.cfg).items()}}

    def head(self):
        """``embed`` and ``ln_f``."""
        d = self.cfg.d_model
        return {"embed": self.normal((L.vocab_pad_of(self.cfg.vocab), d), d ** -0.5),
                "ln_f": self.zeros((d,))}

    def proj(self):
        fd = self.cfg.frontend_dim
        return self.normal((fd, self.cfg.d_model), fd ** -0.5)


def _init_hybrid(draw: _Draw) -> Dict:
    cfg = draw.cfg
    per = cfg.hybrid_attn_every
    n_blocks = cfg.n_layers // per
    n_tail = cfg.n_layers - n_blocks * per
    p = draw.head()
    p.update(mamba=draw.mamba((n_blocks, per)), shared=draw.block(()))
    if n_tail:
        p["tail"] = draw.mamba((n_tail,))
    return p


def _init_vlm(draw: _Draw) -> Dict:
    cfg = draw.cfg
    n_blocks = cfg.n_layers // cfg.cross_attn_every
    cross = draw.block((n_blocks,))
    cross.update(gate_attn=draw.zeros((n_blocks,)), gate_mlp=draw.zeros((n_blocks,)))
    p = draw.head()
    p.update(proj=draw.proj(),
             blocks={"self": draw.block((n_blocks, cfg.cross_attn_every - 1)),
                     "cross": cross})
    return p


def _init_encdec(draw: _Draw) -> Dict:
    cfg = draw.cfg
    dec = draw.block((cfg.n_layers,))
    dec.update(ln_x=draw.zeros((cfg.n_layers, cfg.d_model)), xattn=draw.attn((cfg.n_layers,)))
    p = draw.head()
    p.update(proj=draw.proj(), enc=draw.block((cfg.enc_layers,)),
             ln_enc=draw.zeros((cfg.d_model,)), dec=dec)
    return p


def pattern_params(params: Dict, cfg: ArchConfig) -> Dict:
    """``build_dense_pattern``'s tree from ``build_dense``'s (views, no
    copy): the first ``n_pat * per`` layers as ``blocks`` [n_pat, per, ...],
    the rest as ``tail``, so both builders run on the same weights."""
    per = cfg.local_global_pattern + 1
    n_pat = cfg.n_layers // per

    def cut(node, fn):
        return {k: cut(v, fn) for k, v in node.items()} if isinstance(node, dict) else fn(node)

    out = {"embed": params["embed"], "ln_f": params["ln_f"],
           "blocks": cut(params["layers"],
                         lambda t: t[:n_pat * per].view((n_pat, per) + t.shape[1:]))}
    if cfg.n_layers > n_pat * per:
        out["tail"] = cut(params["layers"], lambda t: t[n_pat * per:])
    return out


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
    ``layers.ssm`` stacked over layers; the other families' trees as the
    module docstring lists them. The expert slabs go where
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


def shard_params(params: Dict, specs: Dict, mesh) -> Dict:
    """This rank's block of every leaf (``launch/partition.py shard_leaf``
    under ``specs``, e.g. ``param_specs`` of the whole tree): new
    contiguous tensors on each leaf's device."""
    from repro_torch.launch.partition import shard_leaf

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        return shard_leaf(node, spec, mesh)

    return cut(params, specs)
