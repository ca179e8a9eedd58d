"""Rule-based partitioner (port of ``repro.launch.partition``).

Specs are assigned by leaf *name* (last key of its path) and context
(inside a ``moe`` subtree?), with dims addressed from the END so stacking
prefixes ([L, ...] or [blocks, per, ...]) never matter. Every rule is
guarded by divisibility: a dim that does not divide the axis is replicated
(Gemma3's 4 query heads on a 16-way model axis). The rules are the
reference's, rule for rule; ``P`` is the port's ``PartitionSpec``: a tuple
with one entry per leading dim, each None, an axis name or a tuple of
names.

``shard_leaf`` cuts this rank's block of a tensor out by its spec and a
``Mesh``'s coordinates (``models/params.py shard_params`` maps it over a
tree); ``block_shape`` is that block's shape.

``fsdp_rule`` is the reference dry-run's switch to FSDP (ZeRO-3): where a
train step's params and AdamW state at tensor-parallel sharding alone
would pass 8 GB a device, the params themselves are stored under
``zero_specs`` (``data_dims`` names the data-axis dim of each leaf).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe_layer import expert_shard_mode


class P(tuple):
    """PartitionSpec: ``P()`` replicates, ``P(None, "model")`` shards dim 1."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


def tree_map_with_path(fn: Callable, tree, path=()):
    """fn(path of keys, leaf) over a nested dict, keys kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _spec_last(leaf, tp, n_model, offset=1):
    """Shard dim -offset over tp if divisible."""
    dim = leaf.ndim - offset
    if dim >= 0 and leaf.shape[dim] % n_model == 0:
        spec = [None] * leaf.ndim
        spec[dim] = tp
        return P(*spec)
    return P()


def param_specs(cfg: ArchConfig, params_abs, *, tp: str = "model", n_model: int = 16):
    """P tree matching the param tree (tensors, on ``meta`` or anywhere)."""
    moe_mode = expert_shard_mode(cfg, n_model) if cfg.is_moe else None

    def rule(path, leaf):
        names = [str(k) for k in path]
        name = names[-1]
        in_moe = "moe" in names
        nd = leaf.ndim

        if name == "embed":
            return P(tp, None) if leaf.shape[0] % n_model == 0 else P()
        if name == "proj":
            return _spec_last(leaf, tp, n_model)

        if in_moe and name in ("w1", "w3", "w2"):
            if moe_mode == "expert":
                # [..., E, d, de] / [..., E, de, d] -> expert dim = -3
                if leaf.shape[nd - 3] % n_model == 0:
                    spec = [None] * nd
                    spec[nd - 3] = tp
                    return P(*spec)
                return P()
            # hidden mode: shard d_expert
            off = 1 if name in ("w1", "w3") else 2
            return _spec_last(leaf, tp, n_model, offset=off)
        if name == "router":
            return P()
        if name in ("sw1", "sw3"):
            return _spec_last(leaf, tp, n_model)
        if name == "sw2":
            return _spec_last(leaf, tp, n_model, offset=2)

        if name in ("wq", "bq"):
            ok = cfg.n_heads and cfg.n_heads % n_model == 0
            return _spec_last(leaf, tp, n_model) if ok else P()
        if name in ("wk", "wv", "bk", "bv"):
            ok = cfg.n_kv_heads and cfg.n_kv_heads % n_model == 0
            return _spec_last(leaf, tp, n_model) if ok else P()
        if name == "wo":
            ok = cfg.n_heads and cfg.n_heads % n_model == 0
            return _spec_last(leaf, tp, n_model, offset=2) if ok else P()

        if name in ("w1", "w3"):
            return _spec_last(leaf, tp, n_model)
        if name == "w2":
            return _spec_last(leaf, tp, n_model, offset=2)

        # ssm
        if name in ("wz", "wx"):
            return _spec_last(leaf, tp, n_model)
        if name in ("wB", "wC", "conv_B", "conv_C"):
            return P()
        if name == "wdt":
            return _spec_last(leaf, tp, n_model)
        if name == "conv_x":
            return _spec_last(leaf, tp, n_model, offset=2)
        if name in ("A_log", "D", "dt_bias"):
            return _spec_last(leaf, tp, n_model)
        if name == "out_proj":
            return _spec_last(leaf, tp, n_model, offset=2)
        if name == "norm":  # ssm gated-norm scale over d_inner
            return _spec_last(leaf, tp, n_model)

        return P()  # norms, gates, biases, scalars

    return tree_map_with_path(rule, params_abs)


def cache_specs(cfg: ArchConfig, cache_abs, *, dp, tp: str = "model",
                n_model: int = 16, n_dp: int = 16):
    """P tree for a decode cache.

    KV ring caches [.., B, W, Hkv, hd]: batch over dp when divisible; heads
    over tp when divisible, else the W (sequence) dim shards over tp.
    SSM states [.., B, h, n, p] / conv [.., B, C, K]: batch over dp, channel
    dim over tp.
    """
    def rule(path, leaf):
        name = str(path[-1])
        nd = leaf.ndim
        if name in ("pos", "slot_pos"):
            return P()
        spec = [None] * nd
        if name in ("k", "v", "k0", "v0", "ak", "av", "mk", "mv"):
            b_dim, w_dim, h_dim = nd - 4, nd - 3, nd - 2
            if leaf.shape[b_dim] % n_dp == 0:
                spec[b_dim] = dp
            if leaf.shape[h_dim] % n_model == 0:
                spec[h_dim] = tp
            elif leaf.shape[w_dim] % n_model == 0:
                spec[w_dim] = tp
            return P(*spec)
        if name.startswith("ssm"):
            b_dim, h_dim = nd - 4, nd - 3
            if leaf.shape[b_dim] % n_dp == 0:
                spec[b_dim] = dp
            if leaf.shape[h_dim] % n_model == 0:
                spec[h_dim] = tp
            return P(*spec)
        if name.startswith("conv_"):
            b_dim, c_dim = nd - 3, nd - 2
            if leaf.shape[b_dim] % n_dp == 0:
                spec[b_dim] = dp
            if leaf.shape[c_dim] % n_model == 0:
                spec[c_dim] = tp
            return P(*spec)
        return P()

    return tree_map_with_path(rule, cache_abs)


def batch_specs(batch_abs, *, dp, n_dp: int):
    """tokens / frames / patch_embeds: batch over dp when divisible."""
    def rule(path, leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 1 and leaf.shape[0] % n_dp == 0:
            spec[0] = dp
        return P(*spec)
    return tree_map_with_path(rule, batch_abs)


def zero_specs(params_abs, pspecs, *, dp, n_dp: int):
    """ZeRO-1: the optimizer moments additionally sharded over the data axes.

    For each leaf, ``dp`` goes on the largest dim that is (a) unsharded in
    the param spec and (b) divisible by the data-parallel world size
    (``training/optimizer.py ZeRO1`` updates each rank's slice and
    all-gathers the params)."""
    def rule(path, leaf):
        spec = _at(pspecs, path)
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        best, best_size = None, 0
        for i in range(leaf.ndim):
            if dims[i] is None and leaf.shape[i] % n_dp == 0 \
                    and leaf.shape[i] > best_size:
                best, best_size = i, leaf.shape[i]
        if best is None:
            return P(*dims) if any(d is not None for d in dims) else P()
        dims[best] = dp
        return P(*dims)

    return tree_map_with_path(rule, params_abs)


# the reference's budget for params + AdamW state a device at tensor-parallel
# sharding alone (src/repro/launch/dryrun.py): past it the params are FSDP
FSDP_STATE_GB = 8.0


def fsdp_rule(param_bytes: int, n_model: int) -> tuple:
    """(state_gb_dev, on): the reference dry-run's reckoning of a train
    step's bf16 params plus f32 AdamW moments (8 bytes an entry: 4 for each
    byte of a bf16 param) a device under tensor parallelism alone,
    ``param_bytes * (1 + 8 / 2) / n_model / 1e9``, and whether it passes
    ``FSDP_STATE_GB``, so the params are stored under ``zero_specs``."""
    state_gb_dev = param_bytes * (1 + 8 / 2) / n_model / 1e9
    return state_gb_dev, bool(state_gb_dev > FSDP_STATE_GB)


def data_dims(pspecs, zspecs) -> dict:
    """A tree of ``pspecs``' keys whose leaves are the dim ``zero_specs``
    adds the data axes to (an int), or None where it adds none."""
    def dim(ps, zs):
        new = [i for i, e in enumerate(zs) if e is not None and (i >= len(ps) or ps[i] is None)]
        return new[0] if new else None
    return tree_map_with_path(lambda path, zs: dim(_at(pspecs, path), zs), zspecs)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def block_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``
    (``shard_leaf``'s cut)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= mesh.size(entry)
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a new contiguous tensor):
    along each sharded dim, block ``mesh.index(axes)`` of ``mesh.size(axes)``
    equal blocks."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.size(entry)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {entry} ({n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(entry) * size, size)
    return t.clone(memory_format=torch.contiguous_format)
