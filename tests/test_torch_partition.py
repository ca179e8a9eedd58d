"""The port's partitioner (``repro_torch.launch.partition``) and meshes
(``launch/mesh.py``) against ``repro.launch.partition`` / ``mesh``, rule for
rule: ``param_specs`` and ``zero_specs`` of every ``ARCH_IDS`` config's
tree at published widths, ``cache_specs`` of every decode pair's cache and
``batch_specs`` of every pair's batch, on a (16 data, 16 model), a (4, 4)
and a (2 pods x 16 data, 16 model) mesh, leaf for leaf as tuples of axis
names. The reference's trees come from ``jax.eval_shape`` (MoE experts
padded by the mesh's model axis, as its ``build_dense(cfg, mesh_info)``
pads them), the port's on the ``meta`` device. Then ``shard_leaf`` /
``shard_params`` against numpy slicing, the logical production meshes, and
the vlm, the enc-dec and the pattern stack built under a mesh (the
leaf-by-leaf draw of a rank's blocks, their caches' blocks); the ssm and
hybrid trees' specs again at a 2-way model axis, and a built rank's param
blocks and cache under them.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, INPUT_SHAPES as J_SHAPES, get_config as jget, \
    pairs as jpairs, reduced as jreduced
from repro.launch import input_specs as JI, mesh as JMESH, partition as JP
from repro.models.model import build as jbuild
from repro_torch.configs.base import INPUT_SHAPES, get_config, reduced
from repro_torch.launch import mesh as TMESH, partition as TP
from repro_torch.launch.input_specs import decode_capacity, train_batch
from repro_torch.models.model import build
from repro_torch.models.params import init_params, params_from_jax, shard_params
from repro_torch.training.optimizer import tree_leaves

# (n_model, n_dp, data axes)
MESHES = [(16, 16, "data"), (4, 4, "data"), (16, 32, ("pod", "data"))]
PAIRS = [(c.name, s.name) for c, s in jpairs()]


class _FakeMesh:
    """What ``build_dense`` reads of a mesh: the model axis's size."""

    def __init__(self, n_model):
        self.shape = {"model": n_model}


@functools.lru_cache(maxsize=None)
def _ref_params(arch, n_model):
    cfg = jget(arch)
    minfo = {"mesh": _FakeMesh(n_model), "dp": ("data",), "tp": "model"}
    bundle = jbuild(cfg, mesh_info=minfo) if cfg.is_moe else jbuild(cfg)
    return jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch, n_model):
    return init_params(get_config(arch), device="meta", expert_slabs="device", n_model=n_model)


def _ref_leaves(tree, specs):
    """[(key path, spec as a tuple)] of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(tuple(str(getattr(k, "key", k)) for k in path), tuple(s)) for path, s in flat]


def _port_leaves(specs, prefix=()):
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _port_leaves(specs[k], prefix + (k,))]
    return [(prefix, tuple(specs))]


@pytest.mark.parametrize("n_model,n_dp,dp", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero_specs_equal_the_reference(arch, n_model, n_dp, dp):
    cfg, jcfg = get_config(arch), jget(arch)
    jparams, tparams = _ref_params(arch, n_model), _port_params(arch, n_model)
    jspecs = JP.param_specs(jcfg, jparams, n_model=n_model)
    tspecs = TP.param_specs(cfg, tparams, n_model=n_model)
    assert _port_leaves(tspecs) == _ref_leaves(jparams, jspecs)
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jparams)]
    jz = JP.zero_specs(jparams, jspecs, dp=dp, n_dp=n_dp)
    tz = TP.zero_specs(tparams, tspecs, dp=dp, n_dp=n_dp)
    assert _port_leaves(tz) == _ref_leaves(jparams, jz)
    assert any(any(e is not None for e in s) for _, s in _port_leaves(tspecs))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cache_and_batch_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), next(c for c, _ in jpairs() if c.name == arch)
    sh, jsh = INPUT_SHAPES[shape], J_SHAPES[shape]
    for n_model, n_dp, dp in MESHES:
        B = sh.global_batch
        if sh.kind == "decode":
            _, jcache = JI.decode_abs(jcfg, jsh, jbuild(jcfg))
            extras = {"mem_len": min(sh.seq_len, JI.LONG_CACHE_CAP)} \
                if cfg.family == "encdec" else None
            cache = build(cfg).init_cache(B, decode_capacity(cfg, sh), extras, device="meta")
            want = JP.cache_specs(jcfg, jcache, dp=dp, n_model=n_model, n_dp=n_dp)
            got = TP.cache_specs(cfg, cache, dp=dp, n_model=n_model, n_dp=n_dp)
            assert _port_leaves(got) == _ref_leaves(jcache, want)
            step = {"token": torch.empty((B, 1), dtype=torch.int32, device="meta")}
            jstep = {"token": jax.ShapeDtypeStruct((B, 1), np.int32)}
        else:
            step = train_batch(cfg, sh, B, device="meta")
            jstep = JI.train_batch_abs(jcfg, jsh)
        assert _port_leaves(TP.batch_specs(step, dp=dp, n_dp=n_dp)) == \
            _ref_leaves(jstep, JP.batch_specs(jstep, dp=dp, n_dp=n_dp))


def _mesh(shape, axes, coords):
    return dataclasses.replace(TMESH.logical_mesh(shape, axes),
                               coords=dict(zip(axes, coords)))


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, 2, 3), (0, 1, 2)])
def test_shard_leaf_is_the_block_of_each_axis(coords):
    """A leaf sharded over (pod, data) on one dim and model on another:
    the block at the rank's row-major index over each dim's axes."""
    mesh = _mesh((2, 3, 4), ("pod", "data", "model"), coords)
    a = np.arange(12 * 8 * 5).reshape(12, 8, 5)
    spec = TP.P(("pod", "data"), "model")
    got = TP.shard_leaf(torch.from_numpy(a), spec, mesh).numpy()
    i = coords[0] * 3 + coords[1]
    np.testing.assert_array_equal(got, a[2 * i:2 * i + 2, 2 * coords[2]:2 * coords[2] + 2])
    assert mesh.index(("pod", "data")) == i and mesh.size(("pod", "data")) == 6
    with pytest.raises(ValueError):
        TP.shard_leaf(torch.zeros(5, 8), TP.P("data"), mesh)


def test_shard_params_is_the_slice_of_the_seeded_tree():
    """Each rank's shard of reduced Qwen2-MoE drawn from a seed (experts
    padded by n_model 2) equals the slice of the tree one device draws, and
    the shards together cover it."""
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    whole = init_params(cfg, 3, "cpu", expert_slabs="device", n_model=2)
    specs = TP.param_specs(cfg, whole, n_model=2)
    assert specs["layers"]["moe"]["w1"] == TP.P(None, "model", None, None)
    assert specs["embed"] == TP.P("model", None)
    blocks = {(d, m): shard_params(whole, specs, _mesh((2, 2), ("data", "model"), (d, m)))
              for d in range(2) for m in range(2)}
    for (d, m), p in blocks.items():
        assert torch.equal(p["layers"]["moe"]["w1"], whole["layers"]["moe"]["w1"][:, 2 * m:2 * m + 2])
        assert torch.equal(p["layers"]["attn"]["wo"], whole["layers"]["attn"]["wo"][:, 64 * m:64 * (m + 1)])
        assert torch.equal(p["ln_f"], whole["ln_f"])
        assert p["embed"].is_contiguous() and p["embed"].data_ptr() != whole["embed"].data_ptr()
    w1 = torch.cat([blocks[(0, m)]["layers"]["moe"]["w1"] for m in range(2)], 1)
    assert torch.equal(w1, whole["layers"]["moe"]["w1"])


def test_shard_params_of_the_reference_tree():
    """``params_from_jax`` of the reference's tree (experts padded by a
    2-way model axis), then each rank's ``shard_params``, equals numpy's
    slice of the reference's arrays under the reference's own specs."""
    jcfg = jreduced(jget("qwen2_moe_a2_7b"))
    bundle = jbuild(jcfg, mesh_info={"mesh": _FakeMesh(2), "dp": ("data",), "tp": "model"})
    jp = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(4)))
    tp = params_from_jax(jp, device="cpu", expert_slabs="device")
    jspecs = JP.param_specs(jcfg, jp, n_model=2)
    specs = TP.param_specs(reduced(get_config("qwen2_moe_a2_7b")), tp, n_model=2)
    sizes = {"data": 2, "model": 2}
    for d in range(2):
        for m in range(2):
            coords = {"data": d, "model": m}
            got = shard_params(tp, specs, _mesh((2, 2), ("data", "model"), (d, m)))
            for t, a, spec in zip(tree_leaves(got), jax.tree.leaves(jp), jax.tree.leaves(
                    jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
                idx = tuple(slice(None) if e is None else
                            slice(coords[e] * (a.shape[i] // sizes[e]),
                                  (coords[e] + 1) * (a.shape[i] // sizes[e]))
                            for i, e in enumerate(tuple(spec) + (None,) * (a.ndim - len(spec))))
                np.testing.assert_array_equal(t.float().numpy(), a[idx].astype(np.float32))


def test_production_meshes_and_info_match_the_reference():
    for multi in (False, True):
        m = TMESH.make_production_mesh(multi_pod=multi)
        info = TMESH.mesh_info(m)
        axes = tuple(m.shape)
        # the reference's mesh_info over a one-device mesh of the same axes
        jinfo = JMESH.mesh_info(jax.make_mesh((1,) * len(axes), axes))
        assert set(info) == set(jinfo) and info["dp"] == jinfo["dp"]
        assert info["tp"] == jinfo["tp"] == "model"
        assert TMESH.n_chips(m) == (512 if multi else 256)
        assert tuple(m.shape.values()) == ((2, 16, 16) if multi else (16, 16))
        with pytest.raises(KeyError):
            m.axis("model")            # a logical mesh has no process group
    assert (TMESH.PEAK_FLOPS_BF16, TMESH.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "llama_3_2_vision_90b", "gemma3_1b"])
def test_every_family_builds_under_a_mesh(arch, monkeypatch):
    """The vlm, the enc-dec and (under ``REPRO_OPT_STATIC_WINDOW``) the
    pattern stack build under a mesh: on each rank of a logical 2 x 2 mesh
    ``init(blocks=True)``, drawn and cut leaf by leaf, equals
    ``shard_params`` of the whole draw, and ``init_cache`` is the rank's
    block of the whole cache under ``cache_specs`` (the memory ``mk`` /
    ``mv`` among its leaves; the tail ring ``kt`` / ``vt``, which the
    reference's rule does not name and so leaves whole, laid out as ``k``,
    ``models/model.py _kv_specs``); the pattern tree's specs (``blocks`` /
    ``tail``) equal the reference's ``build_dense_pattern`` tree's at a 2-
    and a 16-way model axis."""
    monkeypatch.setenv("REPRO_OPT_STATIC_WINDOW", "1")
    cfg = reduced(get_config(arch))
    bundle = build(cfg)
    whole = bundle.init(5, "cpu")
    specs = TP.param_specs(cfg, whole, n_model=2)
    extras = {"mem_len": 12} if cfg.family == "encdec" else None
    cache = bundle.init_cache(4, 16, extras, device="meta")
    cspecs = TP.cache_specs(cfg, cache, dp="data", n_model=2, n_dp=2)
    if "kt" in cache:     # the reference's rule names no tail ring; the port lays it as k
        assert cspecs["kt"] == cspecs["vt"] == TP.P()
        cspecs["kt"] = cspecs["vt"] = TP.P(*cspecs["k"][1:])
    for d in range(2):
        for m in range(2):
            mesh = _mesh((2, 2), ("data", "model"), (d, m))
            mesh.groups[("model",)] = None           # a logical mesh: no collectives run
            sharded = build(cfg, mesh_info=TMESH.mesh_info(mesh))
            got, want = sharded.init(5, "cpu", blocks=True), shard_params(whole, specs, mesh)
            assert len(tree_leaves(got)) == len(tree_leaves(want))
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert a.shape == b.shape and torch.equal(a, b)
            blocks = sharded.init_cache(4, 16, extras, device="meta")
            assert set(cache) <= set(blocks)
            for key, t in cache.items():
                assert tuple(blocks[key].shape) == TP.block_shape(tuple(t.shape), cspecs[key],
                                                                  mesh), key
    if cfg.local_global_pattern:
        jcfg = jreduced(jget(arch))
        jp = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
        assert "blocks" in jp and "blocks" in whole
        for n_model in (2, 16):
            assert _port_leaves(TP.param_specs(cfg, whole, n_model=n_model)) == \
                _ref_leaves(jp, JP.param_specs(jcfg, jp, n_model=n_model))


SSM_ARCHS = ["mamba2_2_7b", "zamba2_7b"]


@pytest.mark.parametrize("n_model", [2, 16])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_specs_equal_the_reference(arch, n_model):
    """``param_specs`` of the ssm and hybrid trees and ``cache_specs`` of
    their decode caches (B = 32, 64 slots, the hybrid's ring at its
    window) equal the reference's leaf by leaf at a 2- and a 16-way model
    axis: every head-indexed leaf over the model axis, ``wB`` / ``wC`` /
    ``conv_B`` / ``conv_C`` replicated, the states' heads and the conv
    channels over it in the cache."""
    cfg, jcfg = get_config(arch), jget(arch)
    jparams, tparams = _ref_params(arch, n_model), _port_params(arch, n_model)
    assert _port_leaves(TP.param_specs(cfg, tparams, n_model=n_model)) == \
        _ref_leaves(jparams, JP.param_specs(jcfg, jparams, n_model=n_model))
    B, W = 32, 64
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(B, W))
    cache = build(cfg).init_cache(B, W, device="meta")
    for n_dp in (2, 16):
        want = JP.cache_specs(jcfg, jcache, dp="data", n_model=n_model, n_dp=n_dp)
        got = TP.cache_specs(cfg, cache, dp="data", n_model=n_model, n_dp=n_dp)
        assert _port_leaves(got) == _ref_leaves(jcache, want)
        assert got["ssm"][-3] == "model" and got["conv_B"][-2] == "model"


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_rank_blocks(arch):
    """On a logical 2 x 2 mesh a rank's ``shard_params`` blocks are its
    heads' slices of the reduced tree, and its ``init_cache`` is its
    block of the whole cache under ``cache_specs``."""
    cfg = reduced(get_config(arch))
    whole = init_params(cfg, 0, "cpu")
    specs = TP.param_specs(cfg, whole, n_model=2)
    cache = build(cfg).init_cache(4, 16, device="meta")
    cspecs = TP.cache_specs(cfg, cache, dp="data", n_model=2, n_dp=2)
    if "kt" in cache:     # the reference's rule names no tail ring; the port lays it as k
        assert cspecs["kt"] == cspecs["vt"] == TP.P()
        cspecs["kt"] = cspecs["vt"] = TP.P(*cspecs["k"][1:])
    for d in range(2):
        for m in range(2):
            mesh = _mesh((2, 2), ("data", "model"), (d, m))
            mesh.groups[("model",)] = None           # a logical mesh: no collectives run
            info = TMESH.mesh_info(mesh)
            got = shard_params(whole, specs, mesh)
            stack = got["layers"] if cfg.family == "ssm" else got["mamba"]
            ref = whole["layers"] if cfg.family == "ssm" else whole["mamba"]
            assert torch.equal(stack["ssm"]["A_log"], ref["ssm"]["A_log"][..., 16 * m:16 * (m + 1)])
            assert torch.equal(stack["ssm"]["wB"], ref["ssm"]["wB"])
            blocks = build(cfg, mesh_info=info).init_cache(4, 16, device="meta")
            for key, t in cache.items():
                assert tuple(blocks[key].shape) == TP.block_shape(tuple(t.shape), cspecs[key],
                                                                  mesh), key


@pytest.mark.parametrize("multi", [False, True])
def test_dryrun_mesh_plan_follows_the_reference(multi, tmp_path):
    """``launch/dryrun.py --mesh``: for every pair of ``pairs()``, every
    family's, the per-device bytes reckoned from the reference's own specs
    of its own tree, and its FSDP rule (``state_gb_dev > 8.0``,
    dryrun.py:110-121); a decode pair's cache bytes from the reference's
    ``cache_specs`` of its own cache (the vlm's and the enc-dec's memory
    ``mk`` / ``mv`` among the leaves)."""
    from repro_torch.launch.dryrun import BUDGET_BYTES, main, mesh_plan
    sizes = {"pod": 2, "data": 16, "model": 16}
    dp, n_dp = (("pod", "data"), 32) if multi else ("data", 16)

    def per_device(tree, specs, per_entry=None):
        total = 0
        for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
            shards = int(np.prod([np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e)])
                                  for e in spec if e is not None]))
            total += int(np.prod(leaf.shape)) // shards * (per_entry or leaf.dtype.itemsize)
        return total

    for cfg, shape in jpairs():
        rec = mesh_plan(get_config(cfg.name), INPUT_SHAPES[shape.name], multi_pod=multi)
        assert rec["planned"]
        jparams = _ref_params(cfg.name, 16)
        jspecs = JP.param_specs(cfg, jparams, n_model=16)
        jz = JP.zero_specs(jparams, jspecs, dp=dp, n_dp=n_dp)
        nbytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in jax.tree.leaves(jparams))
        b = rec["bytes_per_device"]
        assert rec["param_bytes"] == nbytes and rec["budget_bytes"] == BUDGET_BYTES
        if shape.kind != "train":
            assert b["params"] == per_device(jparams, jspecs)
            if shape.kind == "decode":
                _, jcache = JI.decode_abs(cfg, shape, jbuild(cfg))
                assert ("mk" in jcache) == (cfg.family in ("vlm", "encdec"))
                assert b["cache"] == per_device(jcache, JP.cache_specs(
                    cfg, jcache, dp=dp, n_model=16, n_dp=n_dp))
            continue
        assert rec["fsdp"] == (nbytes * 5 / 16 / 1e9 > 8.0)
        assert b["params"] == per_device(jparams, jz if rec["fsdp"] else jspecs)
        assert b["moments"] == per_device(jparams, jz, 8)
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert main(["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k", "--mesh",
                 "2x16x16" if multi else "16x16", "--out", str(tmp_path)]) == 0
    assert len(list(tmp_path.glob("kimi-k2-1t-a32b__train_4k__*.json"))) == 1
