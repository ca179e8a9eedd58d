"""Model bundles (port of ``repro.models.model``), every family of the
reference: ``build_dense`` for the dense and MoE decoders (qwen3, granite,
qwen1.5, gemma3, qwen2-moe, kimi-k2, mixtral), ``build_dense_pattern`` for
a local:global stack under ``REPRO_OPT_STATIC_WINDOW`` (gemma3), ``build_vlm``
(llama-3.2-vision), ``build_encdec`` (seamless-m4t), ``build_ssm`` (mamba2)
and ``build_hybrid`` (zamba2).

``build(cfg)`` gives the reference's entry points:

  * ``init(seed, device)``           -> params (``models/params.py``)
  * ``forward(params, batch)``       -> (logits [B,S,Vp], aux) — teacher-forced
  * ``prefill(params, batch)``       -> (last_logits [B,Vp], cache)
  * ``decode_step(params, step, cache)`` -> (logits [B,Vp], cache)
  * ``init_cache(batch_size, capacity, extras=None, device)`` -> an empty cache

``batch`` = {'tokens': [B,S]} (+ 'patch_embeds' [B,P,frontend_dim] for
the vlm, 'frames' [B,F,frontend_dim] for the enc-dec), ``step`` =
{'token': [B,1]}, int tensors on the params' device. Layers run in a Python loop (the reference's
``lax.scan``); while autograd records, each block of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``:
its activations are recomputed in the backward). ``decode_step`` returns a
new cache and leaves its argument as it was, as the reference's does.

Dense / MoE cache: ``k``, ``v`` [L,B,W,Hkv,hd] bf16 ring buffers (``k0``,
``v0`` for the leading dense layers), ``slot_pos`` [W] int32 absolute
position per slot (-1 = empty) and ``pos``; ``pad_cache`` grows the ring
after prefill. ssm cache: ``ssm [L,B,h,n,p]`` f32, ``conv_x/B/C
[L,B,C,K]`` bf16 and ``pos``. The other builders' caches are the
reference's, key for key and shape for shape (each builder's docstring).

Under a (data, model) mesh (``build(cfg, mesh_info=)``, every family) each
rank runs its data shard of the batch on its blocks of the params
(``models/params.py shard_params`` under ``launch/partition.py
param_specs``; ``init(seed, device, blocks=True)`` draws them leaf by leaf),
with the collectives of ``models/layers.py``, ``models/ssm.py`` and
``moe_layer.moe_ffn``; the embedding is vocab-parallel where the padded
vocabulary divides the model axis, so ``forward``'s logits are then this
rank's vocabulary block (``training/train_loop.py`` takes the loss over the
blocks). The vlm's and the enc-dec's frontend projection ``proj`` is
column-parallel where its last dim divides the axis, its output gathered
whole (``collectives.gather_from``); their cross attention keeps its
memory K/V in ``cache_specs``' layout (``layers.cross_kv``).

FSDP (ZeRO-3, the reference dry-run's rule: ``launch/partition.py
fsdp_rule``): where ``mesh_info["fsdp"]`` is set (the tree of each leaf's
data-axis dim, ``partition.data_dims``) a rank holds each leaf as its
slice under ``zero_specs`` (its ``param_specs`` block cut again over the
data axes; ``init(blocks=True)`` draws it so) and ``forward``
gathers a leaf whole only where it is used (``_Sliced``,
``collectives.gather_params``): a layer's leaves inside the function
``_run`` checkpoints, so the backward's recompute gathers them again and
a layer's whole weights live only while it runs; the embedding at the
lookup and again at the head, ``ln_f``, ``ln_enc``, ``proj`` and the
vlm's memory projections where they are applied. A leaf whose data-axis
dim is a stack's layer dim (Mamba2's ``A_log``, ``D``, ``dt_bias``,
``norm``, ``conv_x``: their other large dim is the model axis') holds
whole layers, so it is gathered whole once a forward, where the stack is
indexed. The gradient of each gather reaches the slice summed over the
data axes (reduce-scattered). Only a train step's ranks are FSDP:
``prefill`` and ``decode_step`` take whole blocks, as a serving rank
holds them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives as C
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe_layer as M
from repro_torch.models import opt_flags
from repro_torch.models import ssm as S
from repro_torch.models.params import (attn_dims, cut_data, init_blocks, init_params,
                                       pattern_params)

CHUNKED_MIN_SEQ = 2048  # the reference's switch to chunked (flash) attention


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
    init_cache: Callable   # (batch_size, ...) -> cache
    ring_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh_info: Optional[dict] = None   # the mesh the bundle runs on


def build(cfg: ArchConfig, capacity_factor: Optional[float] = None,
          mesh_info: Optional[dict] = None) -> ModelBundle:
    """The family's builder; a dense local:global stack under
    ``REPRO_OPT_STATIC_WINDOW`` takes ``build_dense_pattern``, as the
    reference's ``build`` does. ``capacity_factor`` goes to ``build_dense``
    (MoE configs), ``mesh_info`` to every builder."""
    if cfg.family == "dense" and cfg.local_global_pattern and opt_flags.static_window():
        return build_dense_pattern(cfg, mesh_info)
    if cfg.family in ("dense", "moe"):
        return build_dense(cfg, capacity_factor, mesh_info)
    builders = {"vlm": build_vlm, "encdec": build_encdec, "ssm": build_ssm,
                "hybrid": build_hybrid}
    if cfg.family not in builders:
        raise KeyError(f"{cfg.name}: no builder for family {cfg.family!r}")
    return builders[cfg.family](cfg, mesh_info)


def _init_fn(cfg: ArchConfig, mesh_info: Optional[dict], post=None, **kw) -> Callable:
    """A bundle's ``init(seed, device, blocks=False)``: ``init_params(cfg,
    seed, device, **kw)`` through ``post``; with ``blocks`` this rank's
    blocks of it on the bundle's mesh, drawn and cut leaf by leaf
    (``models/params.py init_blocks``)."""
    def init(seed: int = 0, device="cuda", blocks: bool = False):
        if not blocks:
            tree = init_params(cfg, seed, device, **kw)
            return tree if post is None else post(tree)
        if post is None:
            return init_blocks(cfg, seed, device, mesh_info, **kw)
        # the tree ``post`` views is drawn in another layout: its blocks, then
        # under FSDP each leaf of the viewed tree cut over the data axes
        tree = post(init_blocks(cfg, seed, device, dict(mesh_info, fsdp=None), **kw))
        dims = mesh_info.get("fsdp")
        return tree if dims is None else cut_data(tree, dims, mesh_info)

    return init


class _Sliced:
    """A param leaf under FSDP in ``forward``: ``t``, this rank's slice
    along ``dim`` over the data axes ``ax``. ``gather()`` is the whole leaf
    (``collectives.gather_params``); indexing a stack keeps the slice
    (entry l of each layer's slice), except where the indexed dim is the
    sliced one: then the whole leaf is gathered once (kept for the next
    index) and entry l of it is a tensor. ``shape`` is the whole leaf's."""

    def __init__(self, t: torch.Tensor, dim: int, ax: C.Axis):
        self.t, self.dim, self.ax, self._whole = t, dim, ax, None

    @property
    def shape(self) -> torch.Size:
        s = list(self.t.shape)
        s[self.dim] *= self.ax.size
        return torch.Size(s)

    @property
    def requires_grad(self) -> bool:
        return self.t.requires_grad

    def gather(self) -> torch.Tensor:
        return C.gather_params(self.t, self.ax, self.dim)

    def __getitem__(self, l):
        if self.dim == 0:
            if self._whole is None:
                self._whole = self.gather()
            return self._whole[l]
        return _Sliced(self.t[l], self.dim - 1, self.ax)


def _whole(node):
    """A param (sub)tree with every ``_Sliced`` leaf gathered whole."""
    if isinstance(node, dict):
        return {k: _whole(v) for k, v in node.items()}
    return node.gather() if isinstance(node, _Sliced) else node


def _fsdp(bundle: "ModelBundle") -> "ModelBundle":
    """The bundle as a builder made it, or under FSDP with ``forward``
    over ``_Sliced`` leaves (module docstring)."""
    minfo = bundle.mesh_info
    dims = minfo.get("fsdp") if minfo else None
    if dims is None:
        return bundle
    ax = minfo["mesh"].axis(tuple(minfo["dp"]))

    def view(node, d):
        if isinstance(node, dict):
            return {k: view(v, d[k]) for k, v in node.items()}
        return node if d is None else _Sliced(node, d, ax)

    forward = bundle.forward
    return dataclasses.replace(
        bundle, forward=lambda params, batch: forward(view(params, dims), batch))


def pad_cache(cache, new_capacity: int, ring_axes: Dict[str, int]):
    """Grow ring-buffer KV caches to ``new_capacity`` slots (zeros after
    the old ones, ``slot_pos`` -1). Valid right after prefill: the
    appended slots keep slot == pos % capacity while the prefill length
    <= old capacity <= new capacity."""
    new = dict(cache)
    for k, ax in ring_axes.items():
        if k not in cache:
            continue
        arr = cache[k]
        extra = new_capacity - arr.shape[ax]
        if extra <= 0:
            continue
        pads = [0, 0] * (arr.ndim - 1 - ax) + [0, extra]
        new[k] = torch.nn.functional.pad(arr, pads)
    sp = cache.get("slot_pos")
    if sp is not None and sp.shape[0] < new_capacity:
        new["slot_pos"] = torch.nn.functional.pad(sp, (0, new_capacity - sp.shape[0]),
                                                  value=-1)
    return new


# ---------------------------------------------------------------------------
# dense / moe decoder family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Shard:
    """A stack's place on the mesh: the mesh, its model axis, and whether
    the stack's MLP hidden dim is sharded over it (``param_specs``: when it
    divides the axis)."""
    mesh_info: dict
    tp: C.Axis
    ff_split: bool


def _ffn_apply(xn, lp, cfg: ArchConfig, dropless: bool, cf: Optional[float] = None,
               shard: Optional[_Shard] = None):
    """The block's FFN: the MLP, or the MoE FFN at capacity T * k
    (``dropless``, decode), at ``capacity_for(T, cf)`` for a given ``cf``,
    else at the exact capacity T (under a mesh ``moe_ffn``'s per-shard
    capacity)."""
    if "moe" in lp:
        if dropless:
            cf = float(cfg.top_k * M.n_experts_padded(cfg))  # => C = T*k
        return M.moe_ffn(xn, lp["moe"], cfg, capacity_factor=cf,
                         mesh_info=shard.mesh_info if shard else None)
    m = lp["mlp"]
    tp = shard.tp if shard is not None and shard.ff_split else None
    return L.swiglu(xn, m["w1"], m["w3"], m["w2"], tp=tp), 0.0


def _seq_parallel_pin(x, mesh_info):
    """The reference's REPRO_OPT_SEQ_PARALLEL pin: a sharding constraint
    that lets GSPMD lower the block outputs' all-reduces to reduce-scatter
    + all-gather. It changes no value, and the port's collectives are
    explicit, so it pins nothing here."""
    return x


def _block_full(x, lp, win: int, cfg: ArchConfig, chunked: bool, static: bool = False,
                cf: Optional[float] = None, shard: Optional[_Shard] = None):
    """One decoder block over a whole sequence (``static``: the window is
    the pattern stack's static one; ``cf``: the MoE capacity factor,
    ``_ffn_apply``; ``shard``: its place on a mesh). Returns (x, (k, v),
    aux)."""
    mesh_info = shard.mesh_info if shard else None
    h, kv = L.self_attn_full(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"],
                             attn_dims(cfg), window=win, chunked=chunked,
                             static_window=static, tp=shard.tp if shard else None)
    x = _seq_parallel_pin(x + h, mesh_info)
    y, aux = _ffn_apply(L.rms_norm(x, lp["ln2"], cfg.rms_eps), lp, cfg, dropless=False, cf=cf,
                        shard=shard)
    return _seq_parallel_pin(x + y, mesh_info), kv, aux


def _block_decode(x, lp, win: int, cfg: ArchConfig, ck, cv, sp, slot, pos,
                  shard: Optional[_Shard] = None):
    """One decoder block for one token; writes its K/V into ck, cv at
    ``slot`` in place (``shard``: its place on a mesh, the cache this
    rank's block). Returns (x, aux)."""
    h, _, _ = L.self_attn_decode(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"],
                                 attn_dims(cfg), ck, cv, sp, slot, pos, window=win,
                                 tp=shard.tp if shard else None)
    x = x + h
    y, aux = _ffn_apply(L.rms_norm(x, lp["ln2"], cfg.rms_eps), lp, cfg, dropless=True,
                        shard=shard)
    return x + y, aux


def _at(node, l):
    """Entry l of every leaf of a param (or cache) tree: a view."""
    return {k: _at(v, l) for k, v in node.items()} if isinstance(node, dict) else node[l]


def _stack(params, name: str):
    """The per-layer param dicts of stack ``name`` (views of its leaves)."""
    stack = params[name]
    return [_at(stack, l) for l in range(_depth(stack))]


def _depth(stack) -> int:
    """The leading (layer) size of a stacked param tree."""
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


def _run(fn, x, *args):
    """fn(x, *args), under ``torch.utils.checkpoint`` where autograd records
    (the reference's per-layer ``jax.checkpoint``). Under FSDP the layer's
    params ``args[0]`` are gathered inside the checkpointed function, so
    its recompute gathers them again."""
    if _has_sliced(args[0]):
        inner = fn

        def fn(x, lp, *rest):
            return inner(x, _whole(lp), *rest)
    if _records(x, args[0]):
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


def _has_sliced(node) -> bool:
    if isinstance(node, dict):
        return any(_has_sliced(v) for v in node.values())
    return isinstance(node, _Sliced)


def _records(x, lp) -> bool:
    """Whether autograd records a block on x with params lp."""
    def leaves(node):
        return [t for v in node.values() for t in leaves(v)] if isinstance(node, dict) else [node]
    return torch.is_grad_enabled() and (x.requires_grad
                                        or any(t.requires_grad for t in leaves(lp)))


def _ring(capacity: int, filled: int, device):
    """``slot_pos`` of a ring of ``capacity`` slots whose first ``filled``
    hold positions 0.. (-1 = empty) and ``pos`` = filled: a prefill's
    cache (filled = capacity = S) or an empty one (filled = 0)."""
    slots = torch.arange(capacity, dtype=torch.int32, device=device)
    return {"slot_pos": torch.where(slots < filled, slots, -1),
            "pos": torch.tensor(filled, dtype=torch.int32, device=device)}


def _slot(cache):
    """(slot, new slot_pos) of the next decode step over the ring of W =
    ``slot_pos``' length slots: slot = pos % W, a one-element tensor on the
    cache's device (the reference's ``pos % W``: nothing is read on the
    host), and slot_pos[slot] = pos."""
    pos = cache["pos"]
    sp = cache["slot_pos"]
    slot = (pos.long() % sp.shape[0]).reshape(1)
    return slot, sp.index_copy(0, slot, pos.reshape(1).to(sp.dtype))


def _kv_specs(cfg: ArchConfig, shapes: Dict[str, tuple], mesh_info: dict) -> list:
    """``cache_specs`` of the K leaves of these whole shapes (the V leaves
    share them) over the mesh, each by the rule of the rings' ``k``: the
    same rule as ``k0`` / ``ak`` / ``mk``'s, and the pattern stack's tail
    ring ``kt``, which the reference's rule does not name (it leaves it
    whole, where a rank here holds its data shard's rows), is laid out as
    ``k``."""
    from repro_torch.launch.partition import cache_specs
    mesh = mesh_info["mesh"]
    dp = tuple(mesh_info["dp"])
    meta = {key: {"k": torch.empty(s, device="meta")} for key, s in shapes.items()}
    specs = cache_specs(cfg, meta, dp=dp if len(dp) > 1 else dp[0], tp=mesh_info["tp"],
                        n_model=mesh.size(mesh_info["tp"]), n_dp=mesh.size(dp))
    return [specs[key]["k"] for key in shapes]


def _kv_blocks(cfg: ArchConfig, shapes: Dict[str, tuple], mesh_info: Optional[dict]) -> dict:
    """The rank's block shape of each whole K ring shape under
    ``cache_specs`` (the shapes themselves without a mesh)."""
    if mesh_info is None:
        return dict(shapes)
    from repro_torch.launch.partition import block_shape
    return {key: block_shape(s, spec, mesh_info["mesh"])
            for (key, s), spec in zip(shapes.items(), _kv_specs(cfg, shapes, mesh_info))}


def _batch_block(batch_size: int, mesh_info: Optional[dict]) -> int:
    """Rows of a whole batch's cache this rank holds: its data shard where
    the data axes divide the batch (``cache_specs``), else all of them."""
    if mesh_info is None:
        return batch_size
    n_dp = mesh_info["mesh"].size(tuple(mesh_info["dp"]))
    return batch_size // n_dp if batch_size % n_dp == 0 else batch_size


def _v_key(key: str) -> str:
    """The V leaf beside a K ring leaf: k -> v, k0 -> v0, ak -> av."""
    return key.replace("k", "v", 1)


def decode_cache(bundle: ModelBundle, cache: dict, capacity: int) -> dict:
    """Prefill's cache as decode's at ``capacity`` slots: the ring padded
    (``pad_cache``), then, on a mesh, this rank's block of slots where
    ``cache_specs`` shards them (blocks of the padded ring, so the padding
    comes first), of the rings (``k``, ``k0``, ``ak``, ``kt``) and of the
    cross attention's memory (``mk``: not a ring, never padded; where its
    slots are cut the cache gains ``mslot_pos``, the whole memory's slot
    positions, all 0, which ``layers.cross_attn_decode`` reads its slot
    count from). Prefill's cache already holds this rank's data shard and
    its KV heads where those are sharded, and every KV head where they are
    not (``layers.self_attn_full``, ``layers.cross_kv``); the ssm leaves are
    already its blocks (``models/ssm.py ssd_forward``)."""
    from repro_torch.launch.partition import shard_leaf
    cache = pad_cache(cache, capacity, bundle.ring_axes)
    minfo = bundle.mesh_info
    if minfo is None:
        return cache
    keys = [key for key in ("k", "k0", "ak", "kt", "mk") if key in cache]
    whole = {key: cache[key].shape[:-2] + (bundle.cfg.n_kv_heads, bundle.cfg.hd)
             for key in keys}    # the rule reads the whole head count
    specs = _kv_specs(bundle.cfg, whole, minfo)
    for key, spec in zip(keys, specs):
        w_dim = cache[key].ndim - 3
        only_w = tuple(e if d == w_dim else None for d, e in enumerate(spec))
        if key == "mk" and only_w[w_dim] is not None:
            cache["mslot_pos"] = _mem_pos(cache[key].shape[w_dim], cache[key].device)
        for leaf in (key, _v_key(key)):
            cache[leaf] = shard_leaf(cache[leaf], only_w, minfo["mesh"])
    return cache


def _mem_pos(slots: int, device) -> torch.Tensor:
    """``mslot_pos``: a memory of ``slots`` slots, each at position 0."""
    return torch.zeros((slots,), dtype=torch.int32, device=device)


def _mem_slots(cache) -> Optional[int]:
    """The whole memory's slot count where the cache holds a block of its
    slots (``mslot_pos``), else None (``layers.cross_attn_decode``)."""
    sp = cache.get("mslot_pos")
    return None if sp is None else sp.shape[0]


def _kv_cache(cfg: ArchConfig, shapes: Dict[str, tuple], mesh_info, device) -> dict:
    """Zero K/V leaves of these whole K shapes (the V leaf beside each),
    this rank's blocks under ``cache_specs`` on a mesh; ``mslot_pos`` where
    the memory's (``mk``) slots are cut."""
    out = {}
    for key, s in _kv_blocks(cfg, shapes, mesh_info).items():
        out[key] = torch.zeros(s, dtype=L.PDT, device=device)
        out[_v_key(key)] = torch.zeros_like(out[key])
        if key == "mk" and s[-3] < shapes[key][-3]:
            out["mslot_pos"] = _mem_pos(shapes[key][-3], device)
    return out


def _frontend(x, proj, d_model: int, tp: Optional[C.Axis]):
    """A frontend's inputs [B,N,frontend_dim] projected to d_model: ``x @
    proj`` where ``proj`` is whole, else this rank's column block of it,
    gathered whole over the model axis (``collectives.gather_from``)."""
    y = L.linear(x.to(L.PDT), _whole(proj))
    return C.gather_from(y, tp, -1) if proj.shape[-1] < d_model else y


def _model_axis(mesh_info: Optional[dict]) -> Optional[C.Axis]:
    return None if mesh_info is None else mesh_info["mesh"].axis(mesh_info["tp"])


def _vocab_head(params, tokens, vp: int, tp: Optional[C.Axis]):
    """(embedded tokens, the tied output projection's function): the
    vocab-parallel pair where the embedding is this rank's block of the
    padded vocabulary (``_embed_tp``, the output's columns this block),
    else the whole table."""
    embed = params["embed"]
    if tp is None or embed.shape[0] == vp:
        return _embed(_whole(embed), tokens), lambda x: _logits(x, _whole(embed))
    return (_embed_tp(_whole(embed), tokens, vp, tp),
            lambda x: _logits(C.copy_to(x, tp), _whole(embed)))


def _whole_vocab(logits, vp: int, tp: Optional[C.Axis]):
    """Last logits [B, V] gathered over the model axis where they are a
    vocabulary block."""
    return C.all_gather(logits, tp, -1) if logits.shape[-1] < vp else logits


def _embed_tp(embed, tokens, vp: int, tp: C.Axis):
    """The vocab-parallel lookup: ids clipped into [0, vp) (the reference's
    ``mode="clip"``), each rank's rows of its vocabulary block and zeros
    elsewhere, summed over the model axis."""
    v_loc = embed.shape[0]
    ids = tokens.long().clamp(0, vp - 1) - tp.index * v_loc
    hit = (ids >= 0) & (ids < v_loc)
    return C.reduce_from(embed[ids.clamp(0, v_loc - 1)] * hit[..., None], tp)


def build_dense(cfg: ArchConfig, capacity_factor: Optional[float] = None,
                mesh_info: Optional[dict] = None) -> ModelBundle:
    """Dense and MoE decoders. ``capacity_factor``: forward and prefill
    dispatch each MoE layer's T tokens into a buffer of ``capacity_for(T,
    capacity_factor)`` rows an expert, as the reference's sharded
    ``moe_ffn`` does per data shard (``launch/dryrun.py`` runs the
    reference dry-run's step so), instead of the exact T (the default:
    drops nothing); decode stays at T * k.

    ``mesh_info`` (``launch/mesh.py mesh_info``): the bundle runs on one
    rank of that mesh. ``init`` draws the whole tree, its experts padded by
    the model axis (``shard_params`` then cuts the rank's blocks);
    ``forward`` and ``prefill`` take the rank's data shard and its param
    blocks, and the MoE layers dispatch at ``capacity_for`` the shard's
    tokens (``capacity_factor``, the config's when None), as the
    reference's ``shard_map`` body does. ``forward``'s logits are the
    rank's vocabulary block where the embedding is sharded; ``prefill``'s
    and ``decode_step``'s last logits are gathered whole. ``prefill``'s
    cache holds the rank's data shard and its KV heads where they divide
    the model axis, else all of them; ``decode_cache`` takes it to the
    decode layout. ``init_cache(batch_size, ...)`` gives this rank's block
    of the whole batch's cache under ``launch/partition.py cache_specs``
    (batch over the data axes, KV heads or else slots over the model
    axis; ``slot_pos`` and ``pos`` whole), and ``decode_step`` runs on such
    a block: ``layers.self_attn_decode(tp=)`` in either layout, the MoE
    layers through the sharded ``moe_ffn`` at the decode capacity T * k."""
    n_dense = cfg.n_dense_layers
    windows = [cfg.window_for_layer(l) for l in range(n_dense, cfg.n_layers)]
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    shards = {"": None, "0": None}
    if tp is not None:
        shards = {key: _Shard(mesh_info, tp, ff % tp.size == 0)
                  for key, ff in (("", cfg.d_ff), ("0", cfg.dense_d_ff))}
    n_model = tp.size if tp is not None else 16

    init = _init_fn(cfg, mesh_info, expert_slabs="device", n_model=n_model)

    def _stacks(params):
        """(cache key, layer params, window) of every layer, in order."""
        out = [("0", lp, -1) for lp in _stack(params, "dense0")] if n_dense else []
        return out + [("", lp, w) for lp, w in zip(_stack(params, "layers"), windows)]

    def forward(params, batch):
        tokens = batch["tokens"]
        x, head = _vocab_head(params, tokens, vp, tp)
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        aux = 0.0
        for key, lp, win in _stacks(params):
            x, _, a = _run(_block_full, x, lp, win, cfg, chunked, False, capacity_factor,
                           shards[key])
            aux = aux + a
        x = L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps)
        return head(x), aux / cfg.n_layers

    def prefill(params, batch):
        tokens = batch["tokens"]
        B, Ssz = tokens.shape
        x, head = _vocab_head(params, tokens, vp, tp)
        chunked = Ssz >= CHUNKED_MIN_SEQ
        kv = {"": [], "0": []}
        for key, lp, win in _stacks(params):
            x, (k, v), _ = _block_full(x, lp, win, cfg, chunked, False, capacity_factor,
                                       shards[key])
            kv[key].append((k, v))
        cache = {}
        for key, rows in kv.items():
            if rows:
                cache["k" + key] = torch.stack([k for k, _ in rows])
                cache["v" + key] = torch.stack([v for _, v in rows])
        cache.update(_ring(Ssz, Ssz, tokens.device))
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        pos = cache["pos"]
        slot, sp = _slot(cache)
        new = dict(cache, slot_pos=sp, pos=pos + 1)
        for key in ("k", "v", "k0", "v0"):
            if key in cache:
                new[key] = cache[key].clone()
        count = {"": 0, "0": 0}
        for key, lp, win in _stacks(params):
            l = count[key]
            count[key] += 1
            x, _ = _block_decode(x, lp, win, cfg, new["k" + key][l], new["v" + key][l],
                                 sp, slot, pos, shards[key])
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int, extras=None, device="cuda"):
        shape = (batch_size, capacity, cfg.n_kv_heads, cfg.hd)
        kv = {"k": (cfg.n_layers - n_dense,) + shape}
        if n_dense:
            kv["k0"] = (n_dense,) + shape
        return dict(_ring(capacity, 0, device), **_kv_cache(cfg, kv, mesh_info, device))

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             ring_axes={"k": 2, "v": 2, "k0": 2, "v0": 2}, mesh_info=mesh_info))


# ---------------------------------------------------------------------------
# pattern-block dense variant (REPRO_OPT_STATIC_WINDOW): local:global stacks
# (gemma3) as blocks of ``local_global_pattern + 1`` layers with static windows
# ---------------------------------------------------------------------------


def _shard_of(cfg: ArchConfig, tp: Optional[C.Axis], mesh_info) -> Optional[_Shard]:
    """A stack's ``_Shard`` of ``d_ff`` on the mesh, None without one."""
    return None if tp is None else _Shard(mesh_info, tp, cfg.d_ff % tp.size == 0)


def build_dense_pattern(cfg: ArchConfig, mesh_info: Optional[dict] = None) -> ModelBundle:
    """The dense stack as ``n_pat`` blocks of ``per`` layers, then a tail:
    params ``blocks`` [n_pat, per, ...] and ``tail`` [n_tail, ...]
    (``models.params.pattern_params`` cuts them out of ``build_dense``'s
    tree); cache ``k``, ``v`` [n_pat, per, B, W, Hkv, hd], ``kt``, ``vt``
    [n_tail, B, W, Hkv, hd], ``slot_pos``, ``pos``. Each inner position's
    window is static, so on the CPU a chunked local layer takes the
    band-restricted ``attention_chunked_windowed``; on the card the kernel
    skips the key tiles outside the window either way, and the logits equal
    ``build_dense``'s.

    ``mesh_info``: the bundle runs on one rank of that mesh, each layer as
    ``build_dense``'s (``_block_full`` / ``_block_decode`` with the stack's
    ``_Shard``), the embedding vocab-parallel; ``init_cache`` gives the
    rank's blocks of ``k`` and ``kt`` under ``cache_specs`` (gemma3's one KV
    head: the ring's slots over the model axis, a local layer's window
    then often wholly inside one rank's block, the other's log-sum-exp
    -inf and its weight 0)."""
    if not cfg.local_global_pattern or cfg.is_moe or cfg.n_dense_layers:
        raise ValueError(f"{cfg.name}: build_dense_pattern takes a dense local:global stack")
    per = cfg.local_global_pattern + 1
    n_pat = cfg.n_layers // per
    n_tail = cfg.n_layers - n_pat * per
    win_in = [cfg.window_for_layer(i) for i in range(per)]
    win_tail = [cfg.window_for_layer(n_pat * per + i) for i in range(n_tail)]
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    shard = _shard_of(cfg, tp, mesh_info)
    init = _init_fn(cfg, mesh_info, post=lambda p: pattern_params(p, cfg))

    def _layers(params):
        """(cache key, index, layer params, window) of every layer, in order."""
        out = []
        for b in range(n_pat):
            blk = _at(params["blocks"], b)
            out += [("", (b, i), _at(blk, i), win_in[i]) for i in range(per)]
        if n_tail:
            out += [("t", (i,), _at(params["tail"], i), win_tail[i]) for i in range(n_tail)]
        return out

    def _run_full(params, tokens, emit_kv):
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        x, head = _vocab_head(params, tokens, vp, tp)
        kv = {"": [], "t": []}
        for key, _, lp, win in _layers(params):
            x, (k, v), _ = _run(_block_full, x, lp, win, cfg, chunked, True, None, shard)
            if emit_kv:
                kv[key].append((k, v))
        return head, L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps), kv

    def forward(params, batch):
        head, x, _ = _run_full(params, batch["tokens"], emit_kv=False)
        return head(x), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        head, x, kv = _run_full(params, tokens, emit_kv=True)
        shape = (kv[""] or kv["t"])[0][0].shape     # [B, S, the rank's KV heads, hd]

        def stacked(rows, lead):   # n_pat may be 0 (fewer layers than a block)
            t = (torch.stack(rows) if rows
                 else torch.zeros((0,) + shape, dtype=L.PDT, device=tokens.device))
            return t.reshape(lead + shape)

        cache = {"k": stacked([k for k, _ in kv[""]], (n_pat, per)),
                 "v": stacked([v for _, v in kv[""]], (n_pat, per)),
                 **_ring(tokens.shape[1], tokens.shape[1], tokens.device)}
        if n_tail:
            cache["kt"] = stacked([k for k, _ in kv["t"]], (n_tail,))
            cache["vt"] = stacked([v for _, v in kv["t"]], (n_tail,))
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        pos = cache["pos"]
        slot, sp = _slot(cache)
        new = dict(cache, slot_pos=sp, pos=pos + 1)
        for key in ("k", "v", "kt", "vt"):
            if key in cache:
                new[key] = cache[key].clone()
        for key, idx, lp, win in _layers(params):
            x, _ = _block_decode(x, lp, win, cfg, new["k" + key][idx], new["v" + key][idx],
                                 sp, slot, pos, shard)
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int, extras=None, device="cuda"):
        shape = (batch_size, capacity, cfg.n_kv_heads, cfg.hd)
        kv = {"k": (n_pat, per) + shape}
        if n_tail:
            kv["kt"] = (n_tail,) + shape
        c = _kv_cache(cfg, kv, mesh_info, device)
        return dict(c, **_ring(capacity, 0, device))

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             ring_axes={"k": 3, "v": 3, "kt": 2, "vt": 2}, mesh_info=mesh_info))


# ---------------------------------------------------------------------------
# vlm family (llama-3.2-vision): blocks of [n_self self-attn + 1 cross-attn]
# ---------------------------------------------------------------------------


def _gate(g, like):
    """tanh of a gate scalar, in f32, cast to the residual's type."""
    return torch.tanh(g.float()).to(like.dtype)


def build_vlm(cfg: ArchConfig, mesh_info: Optional[dict] = None) -> ModelBundle:
    """``n_layers / cross_attn_every`` blocks of ``cross_attn_every - 1``
    self-attention layers and one gated cross-attention layer over the
    projected patch embeddings (``proj``: frontend_dim -> d_model). Params
    ``blocks.self`` [n_blocks, n_self, ...], ``blocks.cross`` [n_blocks, ...]
    with scalar ``gate_attn`` and ``gate_mlp`` (zero at init: a fresh cross
    layer is the identity); cache ``k``, ``v`` [n_blocks, n_self, B, W, Hkv,
    hd], the memory's ``mk``, ``mv`` [n_blocks, B, P, Hkv, hd], ``slot_pos``,
    ``pos``.

    ``mesh_info``: the bundle runs on one rank of that mesh: the self
    layers as ``build_dense``'s, the cross layer's attention tensor-parallel
    (``layers.cross_kv`` / ``cross_attn_full`` / ``cross_attn_decode`` with
    ``tp``) and its MLP as a block's, the gates whole; the embedding
    vocab-parallel; the projected patches gathered whole where ``proj`` is
    sharded (``_frontend``). ``prefill``'s memory K/V hold the rank's data
    shard and its KV heads where ``wk`` is sharded, else every head and
    every slot (``decode_cache`` cuts the slots where ``cache_specs`` does);
    ``init_cache`` gives the rank's blocks of ``k`` and ``mk`` under
    ``cache_specs``."""
    n_self = cfg.cross_attn_every - 1
    n_blocks = cfg.n_layers // cfg.cross_attn_every
    if n_blocks * cfg.cross_attn_every != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole blocks")
    dims = attn_dims(cfg)
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    shard = _shard_of(cfg, tp, mesh_info)
    ff_tp = shard.tp if shard is not None and shard.ff_split else None
    init = _init_fn(cfg, mesh_info)

    def _cross_rest(x, cp, h):
        """The cross layer after its attention h: both gated residuals."""
        x = x + _gate(cp["gate_attn"], x) * h
        y = L.swiglu(L.rms_norm(x, cp["ln2"], cfg.rms_eps),
                     cp["mlp"]["w1"], cp["mlp"]["w3"], cp["mlp"]["w2"], tp=ff_tp)
        return x + _gate(cp["gate_mlp"], x) * y

    def _cross_full(x, cp, mk, mv):
        return _cross_rest(x, cp, L.cross_attn_full(L.rms_norm(x, cp["ln1"], cfg.rms_eps),
                                                    cp["attn"], dims, mk, mv, tp=tp))

    def _run_full(params, batch, emit_kv):
        tokens = batch["tokens"]
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        mem = _frontend(batch["patch_embeds"], params["proj"], cfg.d_model, tp)
        x, head = _vocab_head(params, tokens, vp, tp)
        self_kv, cross_kv = [], []
        for b in range(n_blocks):
            blk = _at(params["blocks"], b)
            for i in range(n_self):
                x, kv, _ = _run(_block_full, x, _at(blk["self"], i), -1, cfg, chunked, False,
                                None, shard)
                if emit_kv:
                    self_kv.append(kv)
            kv_proj = {k: v for k, v in blk["cross"]["attn"].items() if k in ("wk", "wv", "k_norm")}
            mk, mv = L.cross_kv(mem, _whole(kv_proj), dims, tp)
            x = _run(_cross_full, x, blk["cross"], mk, mv)
            if emit_kv:
                cross_kv.append((mk, mv))
        return head, L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps), self_kv, cross_kv

    def forward(params, batch):
        head, x, _, _ = _run_full(params, batch, emit_kv=False)
        return head(x), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        Ssz = tokens.shape[1]
        head, x, self_kv, cross_kv = _run_full(params, batch, emit_kv=True)
        ks, vs = torch.stack([k for k, _ in self_kv]), torch.stack([v for _, v in self_kv])
        cache = {"k": ks.reshape((n_blocks, n_self) + ks.shape[1:]),
                 "v": vs.reshape((n_blocks, n_self) + vs.shape[1:]),
                 "mk": torch.stack([k for k, _ in cross_kv]),
                 "mv": torch.stack([v for _, v in cross_kv]),
                 **_ring(Ssz, Ssz, tokens.device)}
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        pos = cache["pos"]
        slot, sp = _slot(cache)
        new = dict(cache, k=cache["k"].clone(), v=cache["v"].clone(), slot_pos=sp, pos=pos + 1)
        for b in range(n_blocks):
            blk = _at(params["blocks"], b)
            for i in range(n_self):
                x, _ = _block_decode(x, _at(blk["self"], i), -1, cfg, new["k"][b, i],
                                     new["v"][b, i], sp, slot, pos, shard)
            cp = blk["cross"]
            x = _cross_rest(x, cp, L.cross_attn_decode(
                L.rms_norm(x, cp["ln1"], cfg.rms_eps), cp["attn"], dims, cache["mk"][b],
                cache["mv"][b], tp=tp, mem_slots=_mem_slots(cache)))
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int, extras=None, device="cuda"):
        hkv, hd = cfg.n_kv_heads, cfg.hd
        return dict(_kv_cache(cfg, {
            "k": (n_blocks, n_self, batch_size, capacity, hkv, hd),
            "mk": (n_blocks, batch_size, cfg.n_frontend_tokens, hkv, hd)}, mesh_info, device),
            **_ring(capacity, 0, device))

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             ring_axes={"k": 3, "v": 3}, mesh_info=mesh_info))


# ---------------------------------------------------------------------------
# encoder-decoder family (seamless-m4t): audio frames -> encoder; text decoder
# ---------------------------------------------------------------------------


def build_encdec(cfg: ArchConfig, mesh_info: Optional[dict] = None) -> ModelBundle:
    """A non-causal encoder of ``enc_layers`` over the projected frames
    (``proj``, ``enc``, ``ln_enc``) and a causal decoder of ``n_layers``
    whose blocks add cross attention to the encoder output (``dec`` with
    ``ln_x`` / ``xattn``). Cache ``k``, ``v`` [L, B, W, Hkv, hd], the
    encoder output's ``mk``, ``mv`` [L, B, M, Hkv, hd] (``init_cache`` takes
    M from ``extras["mem_len"]``, else the capacity), ``slot_pos``, ``pos``.

    ``mesh_info``: the bundle runs on one rank of that mesh: the encoder's
    layers and the decoder's self, cross (``xattn``) and MLP layers
    tensor-parallel as ``build_vlm``'s, the projected frames gathered whole
    where ``proj`` is sharded, the embedding vocab-parallel; the caches as
    ``build_vlm``'s (``init_cache``: the rank's blocks of ``k`` and ``mk``
    under ``cache_specs``)."""
    dims = attn_dims(cfg)
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    shard = _shard_of(cfg, tp, mesh_info)
    ff_tp = shard.tp if shard is not None and shard.ff_split else None
    init = _init_fn(cfg, mesh_info)

    def _mlp(x, lp):
        return L.swiglu(L.rms_norm(x, lp["ln2"], cfg.rms_eps),
                        lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"], tp=ff_tp)

    def _enc_block(x, lp, chunked):
        h, _ = L.self_attn_full(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"], dims,
                                causal=False, chunked=chunked, tp=tp)
        x = x + h
        return x + _mlp(x, lp)

    def encode(params, frames):
        x = _frontend(frames, params["proj"], cfg.d_model, tp)
        chunked = x.shape[1] >= CHUNKED_MIN_SEQ
        for lp in _stack(params, "enc"):
            x = _run(_enc_block, x, lp, chunked)
        return L.rms_norm(x, _whole(params["ln_enc"]), cfg.rms_eps)

    def _dec_block(x, lp, enc_out, chunked):
        h, kv = L.self_attn_full(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"], dims,
                                 chunked=chunked, tp=tp)
        x = x + h
        mk, mv = L.cross_kv(enc_out, lp["xattn"], dims, tp)
        x = x + L.cross_attn_full(L.rms_norm(x, lp["ln_x"], cfg.rms_eps), lp["xattn"], dims,
                                  mk, mv, tp=tp)
        return x + _mlp(x, lp), kv, (mk, mv)

    def _dec_full(params, tokens, enc_out, emit_kv):
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        x, head = _vocab_head(params, tokens, vp, tp)
        kvs = []
        for lp in _stack(params, "dec"):
            x, kv, mkv = _run(_dec_block, x, lp, enc_out, chunked)
            if emit_kv:
                kvs.append((kv, mkv))
        return head, L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps), kvs

    def forward(params, batch):
        enc_out = encode(params, batch["frames"])
        head, x, _ = _dec_full(params, batch["tokens"], enc_out, emit_kv=False)
        return head(x), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        Ssz = tokens.shape[1]
        enc_out = encode(params, batch["frames"])
        head, x, kvs = _dec_full(params, tokens, enc_out, emit_kv=True)
        cache = {name: torch.stack([pick(kv) for kv in kvs]) for name, pick in (
            ("k", lambda e: e[0][0]), ("v", lambda e: e[0][1]),
            ("mk", lambda e: e[1][0]), ("mv", lambda e: e[1][1]))}
        cache.update(_ring(Ssz, Ssz, tokens.device))
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        pos = cache["pos"]
        slot, sp = _slot(cache)
        new = dict(cache, k=cache["k"].clone(), v=cache["v"].clone(), slot_pos=sp, pos=pos + 1)
        for l, lp in enumerate(_stack(params, "dec")):
            h, _, _ = L.self_attn_decode(L.rms_norm(x, lp["ln1"], cfg.rms_eps), lp["attn"],
                                         dims, new["k"][l], new["v"][l], sp, slot, pos, tp=tp)
            x = x + h
            x = x + L.cross_attn_decode(L.rms_norm(x, lp["ln_x"], cfg.rms_eps), lp["xattn"],
                                        dims, cache["mk"][l], cache["mv"][l], tp=tp,
                                        mem_slots=_mem_slots(cache))
            x = x + _mlp(x, lp)
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int, extras=None, device="cuda"):
        hkv, hd = cfg.n_kv_heads, cfg.hd
        mem_len = extras["mem_len"] if extras else capacity
        return dict(_kv_cache(cfg, {"k": (cfg.n_layers, batch_size, capacity, hkv, hd),
                                    "mk": (cfg.n_layers, batch_size, mem_len, hkv, hd)},
                              mesh_info, device), **_ring(capacity, 0, device))

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             ring_axes={"k": 2, "v": 2}, mesh_info=mesh_info))


# ---------------------------------------------------------------------------
# ssm family (mamba2)
# ---------------------------------------------------------------------------


def _layer(params, l: int):
    return params["layers"]["ln"][l], {k: v[l] for k, v in params["layers"]["ssm"].items()}


def _mamba_full(x, lp, cfg: ArchConfig, tp: Optional[C.Axis] = None):
    """One pre-norm Mamba2 layer (``lp``: ``ln`` and ``ssm``) over a whole
    sequence (``tp``: the model axis, ``models/ssm.py``). Returns (x, final
    state, conv tails)."""
    y, hfin, tails = S.ssd_forward(L.rms_norm(x, lp["ln"], cfg.rms_eps), lp["ssm"], cfg,
                                   tp=tp)
    return x + y, hfin, tails


def _ssm_cache_block(cfg: ArchConfig, batch_size: int, lead: tuple, mesh_info, device) -> dict:
    """Zeros of the ssm / conv_* leaves [*lead, B, ...] of a whole batch's
    cache, this rank's block under ``cache_specs`` on a mesh."""
    one = S.init_ssm_cache(cfg, _batch_block(batch_size, mesh_info), device=device,
                           tp=_model_axis(mesh_info))
    return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=device) for k, v in one.items()}


def build_ssm(cfg: ArchConfig, mesh_info: Optional[dict] = None) -> ModelBundle:
    """Mamba2 layers. Cache ``ssm`` [L,B,h,n,p] f32, ``conv_x/B/C`` [L,B,C,K]
    and ``pos``. ``mesh_info``: the bundle runs on one rank of that mesh,
    each layer on the rank's heads (``models/ssm.py``), the embedding and
    logits vocab-parallel as ``build_dense``'s; ``init_cache`` gives the
    rank's block of a whole batch's cache under ``cache_specs``, which
    ``prefill`` also returns."""
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    S.ssm_axis(cfg, tp)            # refuses a mesh that splits channels but not heads

    init = _init_fn(cfg, mesh_info)

    def _run_full(params, tokens, emit_state):
        x, head = _vocab_head(params, tokens, vp, tp)
        states = []
        for lp in _stack(params, "layers"):
            x, hfin, tails = _run(_mamba_full, x, lp, cfg, tp)
            if emit_state:
                states.append((hfin, tails))
        return head, L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps), states

    def forward(params, batch):
        head, x, _ = _run_full(params, batch["tokens"], emit_state=False)
        return head(x), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        head, x, states = _run_full(params, tokens, emit_state=True)
        cache = {"ssm": torch.stack([h for h, _ in states]),
                 "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=params["embed"].device)}
        for k in ("x", "B", "C"):
            cache[f"conv_{k}"] = torch.stack([t[k] for _, t in states])
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        new = {k: torch.empty_like(cache[k])
               for k in ("ssm", "conv_x", "conv_B", "conv_C")}
        for l in range(cfg.n_layers):
            ln, lp = _layer(params, l)
            y, st, conv = S.ssd_decode_step(
                L.rms_norm(x, ln, cfg.rms_eps), lp, cfg, cache["ssm"][l],
                {k: cache[f"conv_{k}"][l] for k in ("x", "B", "C")}, tp=tp)
            new["ssm"][l] = st
            for k in ("x", "B", "C"):
                new[f"conv_{k}"][l] = conv[k]
            x = x + y
        new["pos"] = cache["pos"] + 1
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int = 0, extras=None, device="cuda"):
        """The reference's signature; the state has no slots, so
        ``capacity`` and ``extras`` are unused."""
        cache = _ssm_cache_block(cfg, batch_size, (cfg.n_layers,), mesh_info, device)
        cache["pos"] = torch.tensor(0, dtype=torch.int32, device=device)
        return cache

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             mesh_info=mesh_info))


# ---------------------------------------------------------------------------
# hybrid family (zamba2): mamba2 backbone + weight-shared attn block
# ---------------------------------------------------------------------------

def _tail_key(k: str) -> str:
    """The tail's name of an ssm cache leaf: ssm -> ssm_t, conv_x -> conv_xt."""
    return "ssm_t" if k == "ssm" else k + "t"


def build_hybrid(cfg: ArchConfig, mesh_info: Optional[dict] = None) -> ModelBundle:
    """``n_layers // hybrid_attn_every`` blocks of ``hybrid_attn_every`` Mamba2
    layers, each followed by one application of a single weight-shared
    attention + MLP block (``shared``) over the window ``sliding_window``,
    then a Mamba2 tail of the remaining layers. Params ``mamba`` [n_blocks,
    per, ...], ``shared`` (one block), ``tail`` [n_tail, ...]. Cache: the
    Mamba layers' ``ssm``, ``conv_x/B/C`` [n_blocks, per, B, ...] (the tail's
    as ``ssm_t``, ``conv_xt/Bt/Ct`` [n_tail, B, ...]) and, per application of
    the shared block, its own ring ``ak``, ``av`` [n_blocks, B, W, Hkv, hd]
    of W = min(S, window) slots, with one ``slot_pos`` [W] and ``pos``.
    Prefill keeps the last W keys, rolled so that slot == pos % W.

    ``mesh_info``: the bundle runs on one rank of that mesh, the Mamba
    layers as ``build_ssm``'s, the shared block as ``build_dense``'s blocks
    (its heads and MLP hidden dim over the model axis where they divide
    it); ``init_cache`` gives the rank's block of a whole batch's cache
    under ``cache_specs`` (the rings' KV heads, else their slots, as
    ``build_dense``'s, which ``decode_cache`` takes prefill's rings to)."""
    per = cfg.hybrid_attn_every
    n_blocks = cfg.n_layers // per
    n_tail = cfg.n_layers - n_blocks * per
    win = cfg.sliding_window or -1
    vp = L.vocab_pad_of(cfg.vocab)
    tp = _model_axis(mesh_info)
    S.ssm_axis(cfg, tp)            # refuses a mesh that splits channels but not heads
    shard = None if tp is None else _Shard(mesh_info, tp, cfg.d_ff % tp.size == 0)

    init = _init_fn(cfg, mesh_info)

    def _mamba_decode(x, lp, cache, idx, new, key):
        """One Mamba layer for one token; its state at ``idx`` of the cache
        leaves ``key(name)`` read from ``cache``, written into ``new``."""
        conv = {k: cache[key(f"conv_{k}")][idx] for k in ("x", "B", "C")}
        y, st, conv = S.ssd_decode_step(L.rms_norm(x, lp["ln"], cfg.rms_eps), lp["ssm"], cfg,
                                        cache[key("ssm")][idx], conv, tp=tp)
        new[key("ssm")][idx] = st
        for k in ("x", "B", "C"):
            new[key(f"conv_{k}")][idx] = conv[k]
        return x + y

    def _run_full(params, tokens, emit):
        chunked = tokens.shape[1] >= CHUNKED_MIN_SEQ
        x, head = _vocab_head(params, tokens, vp, tp)
        states, kvs, tail = [], [], []
        for b in range(n_blocks):
            blk = _at(params["mamba"], b)
            for i in range(per):
                x, hfin, tails = _run(_mamba_full, x, _at(blk, i), cfg, tp)
                if emit:
                    states.append((hfin, tails))
            x, kv, _ = _run(_block_full, x, params["shared"], win, cfg, chunked, False, None,
                            shard)
            if emit:
                kvs.append(kv)
        for i in range(n_tail):
            x, hfin, tails = _run(_mamba_full, x, _at(params["tail"], i), cfg, tp)
            if emit:
                tail.append((hfin, tails))
        return head, L.rms_norm(x, _whole(params["ln_f"]), cfg.rms_eps), states, kvs, tail

    def _ssm_cache(states, lead):
        """ssm / conv_* leaves of a list of (final state, conv tails)."""
        out = {"ssm": torch.stack([h for h, _ in states])}
        for k in ("x", "B", "C"):
            out[f"conv_{k}"] = torch.stack([t[k] for _, t in states])
        return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}

    def forward(params, batch):
        head, x, _, _, _ = _run_full(params, batch["tokens"], emit=False)
        return head(x), 0.0

    def prefill(params, batch):
        tokens = batch["tokens"]
        Ssz = tokens.shape[1]
        head, x, states, kvs, tail = _run_full(params, tokens, emit=True)
        W = min(Ssz, cfg.sliding_window or Ssz)
        shift = (Ssz - W) % W
        roll = lambda t: torch.roll(t, shift, dims=2)
        cache = _ssm_cache(states, (n_blocks, per))
        cache["ak"] = roll(torch.stack([k for k, _ in kvs])[:, :, -W:])
        cache["av"] = roll(torch.stack([v for _, v in kvs])[:, :, -W:])
        cache["slot_pos"] = torch.roll(
            torch.arange(Ssz - W, Ssz, dtype=torch.int32, device=tokens.device), shift)
        cache["pos"] = torch.tensor(Ssz, dtype=torch.int32, device=tokens.device)
        if n_tail:
            cache.update({_tail_key(k): v for k, v in _ssm_cache(tail, (n_tail,)).items()})
        return _whole_vocab(head(x[:, -1]), vp, tp), cache

    def decode_step(params, step, cache):
        x, head = _vocab_head(params, step["token"], vp, tp)
        pos = cache["pos"]
        slot, sp = _slot(cache)
        new = dict(cache, ak=cache["ak"].clone(), av=cache["av"].clone(), slot_pos=sp,
                   pos=pos + 1)
        for k in ("ssm", "conv_x", "conv_B", "conv_C"):
            new[k] = torch.empty_like(cache[k])
            if n_tail:
                new[_tail_key(k)] = torch.empty_like(cache[_tail_key(k)])
        same = lambda k: k
        for b in range(n_blocks):
            blk = _at(params["mamba"], b)
            for i in range(per):
                x = _mamba_decode(x, _at(blk, i), cache, (b, i), new, same)
            x, _ = _block_decode(x, params["shared"], win, cfg, new["ak"][b], new["av"][b],
                                 sp, slot, pos, shard)
        for i in range(n_tail):
            x = _mamba_decode(x, _at(params["tail"], i), cache, i, new, _tail_key)
        x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
        return _whole_vocab(head(x[:, -1]), vp, tp), new

    def init_cache(batch_size: int, capacity: int, extras=None, device="cuda"):
        W = min(capacity, cfg.sliding_window or capacity)
        c = _ssm_cache_block(cfg, batch_size, (n_blocks, per), mesh_info, device)
        ak = _kv_blocks(cfg, {"ak": (n_blocks, batch_size, W, cfg.n_kv_heads, cfg.hd)},
                        mesh_info)["ak"]
        c["ak"] = torch.zeros(ak, dtype=L.PDT, device=device)
        c["av"] = torch.zeros_like(c["ak"])
        c.update(_ring(W, 0, device))
        if n_tail:
            c.update({_tail_key(k): v for k, v in _ssm_cache_block(
                cfg, batch_size, (n_tail,), mesh_info, device).items()})
        return c

    return _fsdp(ModelBundle(cfg, init, forward, prefill, decode_step, init_cache,
                             ring_axes={"ak": 2, "av": 2}, mesh_info=mesh_info))
