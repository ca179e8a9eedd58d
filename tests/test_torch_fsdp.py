"""FSDP (ZeRO-3) of the params on the (data, model) mesh against the JAX
package's: the port's train step with each rank's params held as its
``zero_specs`` slices (``mesh_info["fsdp"]``: gathered a layer at a time
inside the layer's checkpoint, gradients reduce-scattered in the gather's
backward, ``ZeRO1`` updating the slices in place) in a gloo world of 4 CPU
processes (tests/torch_fsdp_world.py), against the reference dry-run's
FSDP branch run for real (the jitted ``make_train_step`` with params and
moments under ``zero_specs``, two microbatches each pinned to the data
axes, the accumulator pinned to ``zero_specs``; tests/torch_fsdp_ref.py,
one subprocess a scenario, 4 forced host devices), and against the port's
own ZeRO-1 step in the same world; then ``fsdp_rule`` against the
reference's arithmetic, the dry-run's plan, and ``launch/train.py
--fsdp``.

Scenarios, each on a 2 x 2 (data, model) mesh, B = 4 x 32 tokens, two
microbatches a rank: reduced Qwen2-MoE-A2.7B; reduced Mamba2-2.7B, whose
``A_log``, ``D``, ``dt_bias`` and ``norm`` take the data axes on the
stack's layer dim (gathered whole once a forward); reduced Zamba2-7B at 3
layers, whose ``shared`` block is unstacked and applied once a block, in
f32 (tests/test_torch_mesh_ssm.py's reason); Mamba2's forward runs in
f32 too, as the witness of its bf16 logits. The vlm, the enc-dec and the
pattern stack run too, from the port's own params, against ZeRO-1 only.

Tolerances (tests/test_torch_mesh.py's, each for the reason given there):
logits ``DEEP`` (the f32 scenario ``F32``); loss and aux 1e-2 relative,
gradient norm 5e-2; each gradient leaf (read from the first moment after
step 1) within ``STEP_GRAD_TOL`` of the leaf's largest entry; the params
after step 2 within ``PARAM_TOL`` of the reference's, as the norm of the
difference over the norm of the reference's update.

Against ZeRO-1 the forward moves the same values through the same
functions, so the logits and step 1's loss are equal bit for bit. The
gradients differ only where they are rounded: ZeRO-1 keeps the f32 sum
over the data axes, FSDP's gather hands autograd that sum rounded to the
leaf's dtype (bf16; a leaf gathered more than once, the embedding or
Zamba2's shared block, adds its bf16 parts), so each leaf is held within
``ROUND_TOL`` (a few bf16 ulps) of the leaf's largest entry.

Planted faults that must fail: the gather's backward keeping the rank's
slice without the sum over the data axes (a gradient leaf parts from the
reference's beyond ``STEP_GRAD_TOL``: the slice holds its own batch
shard's part), and a layer-dim leaf read as if its layer dim were whole,
layer l from the rank's own slice (Mamba2's logits part from the sound
run's beyond ``DEEP``; the layers' per-channel leaves are drawn apart, as
one fill in every layer would hide it).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mesh import B1, CLIP, DEEP, PARAM_TOL, STEP_GRAD_TOL, _err, _mesh, _Npz, _rel
from torch_fsdp_world import F32_WITNESS, FAMILIES, NO_SUM, SCENARIOS, scenario_cfg, tree

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.partition import (block_shape, data_dims, fsdp_rule, param_specs,
                                          shard_leaf, zero_specs)
from repro_torch.training.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=2e-4, atol=2e-4)     # tests/test_torch_families.py's
ROUND_TOL = 1e-2
N_MODEL, N_DP = 2, 2


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _launch():
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--arch", "qwen2-moe-a2.7b", "--mesh", "2x2", "--backend", "gloo", "--spawn",
         "--steps", "2", "--seed", "1", "--fsdp", "on"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's inputs and outputs, [each rank's npz], the
    launcher run's (rc, stdout, stderr)): the reference's scenarios, the
    port's world and the launcher side by side."""
    d = tmp_path_factory.mktemp("fsdp")
    refs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_fsdp_ref.py"), str(d), name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        for name in SCENARIOS}
    t0 = time.monotonic()
    while (not (d / "inputs_moe.npz").exists() and refs["moe"].poll() is None
           and time.monotonic() - t0 < 300):
        time.sleep(0.2)
    world = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_fsdp_world.py"),
                              str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=_env())
    launch = _launch()
    for name, p in refs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (name, out[-3000:] + err[-3000:])
    out, err = world.communicate(timeout=300)
    assert world.returncode == 0, out[-3000:] + err[-3000:]
    launched = (launch.wait(timeout=300),) + launch.communicate()
    z = _Npz()
    for name in SCENARIOS:
        for path in (d / f"inputs_{name}.npz", d / f"ref_{name}.npz"):
            with np.load(path) as f:
                z.update({k: f[k] for k in f.files})
    return z, [np.load(d / f"rank{r}.npz") for r in range(4)], launched


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(cfg, whole):
    pspecs = param_specs(cfg, whole, n_model=N_MODEL)
    return pspecs, zero_specs(whole, pspecs, dp="data", n_dp=N_DP)


def _scale(grad_norm) -> float:
    return (1 - B1) * min(1.0, CLIP / float(grad_norm))


def _grads(w, tag):
    """Step 1's gradient leaves of a rank's run, from its first moment."""
    scale = _scale(w[f"{tag}/metrics0/grad_norm"])
    j, out = 0, []
    while f"{tag}/m0/{j}" in w.files:
        out.append(w[f"{tag}/m0/{j}"] / scale)
        j += 1
    return out


def _case(runs, name):
    z, ranks, _ = runs
    f32 = SCENARIOS[name][2]
    cfg = scenario_cfg(name)
    whole = tree(z, f"{name}/params", f32)
    return cfg, whole, z, ranks, f32


# -- against the port's ZeRO-1 step ---------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS) + list(FAMILIES))
def test_fsdp_forward_and_first_loss_equal_zero1(runs, name):
    """The same values through the same functions: the forward's logits
    and step 1's loss, ce and aux equal ZeRO-1's bit for bit."""
    _, ranks, _ = runs
    for w in ranks:
        np.testing.assert_array_equal(w[f"{name}/fsdp/logits"], w[f"{name}/zero1/logits"])
        for k in ("loss", "ce", "aux"):
            assert w[f"{name}/fsdp/metrics0/{k}"] == w[f"{name}/zero1/metrics0/{k}"], k


@pytest.mark.parametrize("name", list(SCENARIOS) + list(FAMILIES))
def test_fsdp_gradients_are_zero1s_rounded(runs, name):
    """Each gradient leaf of step 1 within ``ROUND_TOL`` of ZeRO-1's (the
    f32 sum rounded to the leaf's dtype), and the gradient norms within
    the same; after two steps the params within ``PARAM_TOL`` of ZeRO-1's
    update."""
    z, ranks, _ = runs
    worst = 0.0
    for w in ranks:
        for j, (a, b) in enumerate(zip(_grads(w, f"{name}/fsdp"), _grads(w, f"{name}/zero1"))):
            assert a.shape == b.shape, j
            if a.size:        # the pattern stack's tree may hold empty blocks
                worst = max(worst, _rel(a, b))
        np.testing.assert_allclose(w[f"{name}/fsdp/metrics0/grad_norm"],
                                   w[f"{name}/zero1/metrics0/grad_norm"], rtol=ROUND_TOL)
    print(f"{name}: worst leaf against ZeRO-1 {worst:.2e}")
    assert worst <= ROUND_TOL
    if name not in SCENARIOS:
        return
    cfg, whole, _, _, _ = _case(runs, name)
    pspecs, zspecs = _specs(cfg, whole)
    dims = tree_leaves(data_dims(pspecs, zspecs))
    num = den = 0.0
    for w in ranks:
        mesh = _mesh((N_DP, N_MODEL), w["coords"])
        fsdp = tree_leaves(tree(w, f"{name}/fsdp/params2", True))
        zero = tree_leaves(tree(w, f"{name}/zero1/params2", True))
        for a, b, p0, zs, dim in zip(fsdp, zero, tree_leaves(whole), tree_leaves(zspecs), dims):
            b = b.numpy() if dim is None else np.split(b.numpy(), N_DP, dim)[w["coords"][0]]
            p0 = shard_leaf(p0.float(), zs, mesh).numpy()
            num += float(((a.numpy() - b) ** 2).sum())
            den += float(((b - p0) ** 2).sum())
    assert np.sqrt(num / den) <= PARAM_TOL, np.sqrt(num / den)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fsdp_params_are_zero_specs_slices(runs, name):
    """A rank holds each leaf as its ``zero_specs`` block (ZeRO-1: its
    ``param_specs`` block), half its ZeRO-1 bytes or near it; Mamba2's
    layer-dim leaves and Zamba2's unstacked shared block among them."""
    cfg, whole, _, ranks, _ = _case(runs, name)
    pspecs, zspecs = _specs(cfg, whole)
    mesh = _mesh((N_DP, N_MODEL), (0, 0))
    dims = data_dims(pspecs, zspecs)
    for w in ranks:
        for j, (t, ps, zs) in enumerate(zip(tree_leaves(whole), tree_leaves(pspecs),
                                            tree_leaves(zspecs))):
            assert tuple(w[f"{name}/fsdp/shape/{j}"]) == block_shape(tuple(t.shape), zs, mesh)
            assert tuple(w[f"{name}/zero1/shape/{j}"]) == block_shape(tuple(t.shape), ps, mesh)
    nbytes = lambda specs: sum(int(np.prod(block_shape(tuple(t.shape), s, mesh)))
                               * t.element_size() for t, s in zip(tree_leaves(whole),
                                                                  tree_leaves(specs)))
    assert nbytes(zspecs) <= 0.55 * nbytes(pspecs)
    if name == "mamba":
        assert {k for k, d in dims["layers"]["ssm"].items() if d == 0} >= {
            "A_log", "D", "dt_bias", "norm"}
    if name == "zamba":
        assert all(d is not None for d in tree_leaves(dims["shared"]))


@pytest.mark.parametrize("name", ["moe", "mamba"])
def test_layers_gather_inside_their_checkpoint(runs, name):
    """A train step's all-gathers are its forward's (a no-grad forward
    makes the same) and, again, each layer's sliced leaves in its
    recompute: the gathers sit inside the checkpointed function, so a
    layer's whole weights are not saved for the backward. A gather outside
    it would make the step's count the forward's alone. Leaves gathered
    whole once a forward (the embedding, ``ln_f``, a layer-dim leaf) are
    not recomputed."""
    cfg = scenario_cfg(name)
    pspecs, zspecs = _specs(cfg, tree(runs[0], f"{name}/params"))
    per_layer = sum(d not in (None, 0) for d in tree_leaves(data_dims(pspecs, zspecs)["layers"]))
    assert per_layer
    for w in runs[1]:
        if name == "moe":
            step, fwd = w["moe_mb1/collectives/all-gather"][0], w["moe_mb1/forward_gathers"]
            assert step == fwd + cfg.n_layers * per_layer, (step, fwd)
        else:   # two steps of two microbatches
            step, fwd = w["mamba/fsdp/collectives/all-gather"][0], w["mamba/fsdp/forward_gathers"]
            assert step == 2 * 2 * (fwd + cfg.n_layers * per_layer), (step, fwd)


def test_each_microbatch_gathers_again(runs):
    """The FSDP step of two microbatches gathers twice what one does (the
    forward's and the recompute's gathers, each microbatch), and ZeRO-1's
    end-of-step all-gathers of the updated params are gone: ZeRO-1 gathers
    each sliced leaf once a step, FSDP reduce-scatters a sliced leaf's
    gradient once each time it is gathered in a forward."""
    _, ranks, _ = runs
    for w in ranks:
        two, one = w["moe/fsdp/collectives/all-gather"], w["moe_mb1/collectives/all-gather"]
        assert two[0] == 2 * 2 * one[0] and two[1] == 2 * 2 * one[1]
        zero = w["moe/zero1/collectives/all-gather"]
        # ZeRO-1's only all-gathers are the updates': one a sliced leaf a step
        assert zero[0] == 2 * sum(d is not None for d in tree_leaves(
            data_dims(*_specs(scenario_cfg("moe"), tree(runs[0], "moe/params")))))
        assert w["moe_mb1/collectives/reduce-scatter"][0] < one[0]


# -- against the reference's FSDP step ------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fsdp_step_matches_reference(runs, name):
    """The FSDP step against the reference dry-run's FSDP branch: each
    step's loss, aux and gradient norm, every gradient leaf of step 1 on
    the rank's slice, the params after step 2; the f32 scenario's forward
    logits too. The bf16 forwards equal ZeRO-1's bit for bit (above), whose
    logits tests/test_torch_mesh.py and test_torch_mesh_ssm.py hold against
    the reference; Mamba2's here, with its per-layer leaves drawn apart,
    read 0.053 by ``_err`` against the reference's, in ZeRO-1 and FSDP
    alike, past ``DEEP``'s 0.05: the packages' bf16 gap, not the mesh's
    (the same draws in f32 hold within ``F32``: the witness below)."""
    cfg, whole, z, ranks, f32 = _case(runs, name)
    pspecs, zspecs = _specs(cfg, whole)
    jscale = _scale(z[f"{name}/metrics0/grad_norm"])
    ref_m = tree_leaves(tree(z, f"{name}/m0", True))
    p2_ref = tree_leaves(tree(z, f"{name}/params2", True))
    num = den = 0.0
    for w in ranks:
        d, m = w["coords"]
        mesh = _mesh((N_DP, N_MODEL), (d, m))
        for i in range(2):
            for k, rtol in (("loss", 1e-2), ("aux", 1e-2), ("grad_norm", 5e-2)):
                want = float(z[f"{name}/metrics{i}/{k}"])
                assert abs(w[f"{name}/fsdp/metrics{i}/{k}"] - want) <= rtol * abs(want) + 1e-6, \
                    (i, k)
        for j, (g, zs) in enumerate(zip(_grads(w, f"{name}/fsdp"), tree_leaves(zspecs))):
            want = shard_leaf(ref_m[j], zs, mesh).numpy() / jscale
            assert g.shape == want.shape, j
            assert _rel(g, want) <= STEP_GRAD_TOL, (j, _rel(g, want))
        got = tree_leaves(tree(w, f"{name}/fsdp/params2", True))
        for a, b, p0, zs in zip(got, p2_ref, tree_leaves(whole), tree_leaves(zspecs)):
            b, p0 = (shard_leaf(t.float(), zs, mesh).numpy() for t in (b, p0))
            num += float(((a.numpy() - b) ** 2).sum())
            den += float(((b - p0) ** 2).sum())
        if f32:
            V = w[f"{name}/fsdp/logits"].shape[-1]
            want = z[f"{name}/io/logits"][2 * d:2 * d + 2, :, m * V:(m + 1) * V]
            assert _err(w[f"{name}/fsdp/logits"], want, F32) <= F32["atol"], (d, m)
    rel = np.sqrt(num / den)
    print(f"{name}: params against the reference {rel:.4f}")
    assert rel <= PARAM_TOL


@pytest.mark.parametrize("name", F32_WITNESS)
def test_fsdp_f32_forward_matches_reference(runs, name):
    """The witness of a bf16 scenario's logits: its FSDP forward on the
    same draws with every leaf cast to f32 and ``PDT`` f32 on both sides,
    against the reference's f32 forward under ``zero_specs``, within
    ``F32``. Mamba2's bf16 logits, its per-layer leaves drawn apart, sit
    past ``DEEP`` against the reference's in ZeRO-1 and FSDP alike; in f32
    the FSDP path (the layer-dim leaves gathered whole, the per-layer
    gathers) agrees with the reference, so that gap is bf16 rounding."""
    z, ranks, _ = runs
    for w in ranks:
        d, m = w["coords"]
        got = w[f"{name}_f32/fsdp/logits"]
        V = got.shape[-1]
        want = z[f"{name}/io/logits_f32"][2 * d:2 * d + 2, :, m * V:(m + 1) * V]
        err = _err(got, want, F32)
        print(f"{name} f32 {(d, m)}: logits {err:.2e}")
        assert err <= F32["atol"], (d, m, err)


@pytest.mark.parametrize("fault", [f"{n}_no_sum" for n in NO_SUM] + ["mamba_layer_slice"])
def test_planted_faults_fail(runs, fault):
    """The gather's backward without the sum over the data axes: some
    gradient leaf of step 1 parts from the reference's beyond
    ``STEP_GRAD_TOL``. A layer-dim leaf read as whole: Mamba2's logits
    part from the sound FSDP run's (ZeRO-1's, bit for bit) beyond
    ``DEEP``."""
    name = fault.split("_")[0]
    cfg, whole, z, ranks, _ = _case(runs, name)
    _, zspecs = _specs(cfg, whole)
    for w in ranks:
        d, m = w["coords"]
        mesh = _mesh((N_DP, N_MODEL), (d, m))
        if fault.endswith("no_sum"):
            jscale = _scale(z[f"{name}/metrics0/grad_norm"])
            errs = [_rel(g, shard_leaf(r, zs, mesh).numpy() / jscale) for g, r, zs in zip(
                _grads(w, fault), tree_leaves(tree(z, f"{name}/m0", True)),
                tree_leaves(zspecs))]
            print(f"{fault} {(d, m)}: worst leaf {max(errs):.3f}")
            assert max(errs) > STEP_GRAD_TOL, errs
        else:
            err = _err(w[f"{fault}/logits"], w[f"{name}/fsdp/logits"], DEEP)
            print(f"{fault} {(d, m)}: logits {err:.3f}")
            assert err > DEEP["atol"], (d, m, err)


# -- the gather --------------------------------------------------------------------


def test_gather_params_forward_and_backward(runs):
    """``gather_params`` on two data ranks: forward the slices in rank
    order; backward the sum over the data ranks of each rank's gradient of
    the whole, summed in f32, this rank's slice, rounded to bf16.
    ``gather_from`` forwards the same but keeps only the rank's own
    gradient: the fault FSDP's gather must not have."""
    _, ranks, _ = runs
    g = torch.Generator().manual_seed(11)
    parts = [torch.randn((3, 4), generator=g).to(torch.bfloat16) for _ in range(N_DP)]
    ups = [torch.randn((3, 8), generator=g) for _ in range(N_DP)]
    whole = torch.cat(parts, 1).float().numpy()
    # each rank's gradient of the bf16 whole is its upstream rounded to bf16
    ups = [u.to(torch.bfloat16).float() for u in ups]
    total = ups[0] + ups[1]
    for w in ranks:
        d = int(w["coords"][0])
        cols = slice(4 * d, 4 * d + 4)
        for tag in ("params", "from"):
            np.testing.assert_array_equal(w[f"gather/{tag}/fwd"], whole)
            assert str(w[f"gather/{tag}/grad_dtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(w["gather/params/grad"],
                                      total[:, cols].to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(w["gather/from/grad"],
                                      ups[d][:, cols].to(torch.bfloat16).float().numpy())
        assert not np.array_equal(w["gather/from/grad"], w["gather/params/grad"])


# -- the rule, the plan, the launcher ----------------------------------------------


class _FakeMesh:
    """What ``build_dense`` reads of a mesh: the model axis's size."""

    def __init__(self, n_model):
        self.shape = {"model": n_model}


@pytest.mark.parametrize("n_model", [2, 16])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_2_7b", "zamba2_7b",
                                  "llama_3_2_vision_90b", "kimi_k2_1t_a32b", "gemma3_1b"])
def test_fsdp_rule_is_the_reference_arithmetic(arch, n_model):
    """``fsdp_rule`` of the port's tree on ``meta`` against the reference
    dry-run's own arithmetic on its tree (``jax.eval_shape``; MoE experts
    padded by the model axis): the same bytes, the same ``state_gb_dev``
    and switch."""
    import jax

    from repro.configs.base import get_config as jget
    from repro.models.model import build as jbuild
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.params import init_params
    jcfg = jget(arch)
    minfo = {"mesh": _FakeMesh(n_model), "dp": ("data",), "tp": "model"}
    bundle = jbuild(jcfg, mesh_info=minfo) if jcfg.is_moe else jbuild(jcfg)
    jparams = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
    param_bytes = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                      for leaf in jax.tree.leaves(jparams))
    state_gb_dev = param_bytes * (1 + 8 / 2) / n_model / 1e9     # the reference's lines
    port = init_params(get_config(arch), device="meta", expert_slabs="device", n_model=n_model)
    assert tree_bytes(port) == param_bytes
    assert fsdp_rule(tree_bytes(port), n_model) == (state_gb_dev, bool(state_gb_dev > 8.0))


@pytest.mark.parametrize("arch,layers,on", [("qwen2_moe_a2_7b", 2, False),
                                            ("qwen2_moe_a2_7b", 3, True),
                                            ("mamba2_2_7b", 2, False),
                                            ("mamba2_2_7b", 64, True)])
def test_fsdp_rule_on_a_2x2_mesh(arch, layers, on):
    """The rule on the 2 x 2 mesh the card's checks run: Qwen2-MoE-A2.7B
    reckons 7.26 GB at 2 layers (off) and 10.12 at 3 (on); Mamba2-2.7B
    1.05 at 2, 13.51 at its 64."""
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    gb, fsdp = fsdp_rule(tree_bytes(init_params(cfg, device="meta", expert_slabs="device",
                                                n_model=N_MODEL)), N_MODEL)
    assert fsdp is on
    assert round(gb, 2) == {("qwen2_moe_a2_7b", 2): 7.26, ("qwen2_moe_a2_7b", 3): 10.12,
                            ("mamba2_2_7b", 2): 1.05, ("mamba2_2_7b", 64): 13.51}[arch, layers]


@pytest.mark.parametrize("arch,shape", [("qwen2_moe_a2_7b", "train_4k"),
                                        ("kimi_k2_1t_a32b", "train_4k"),
                                        ("llama_3_2_vision_90b", "train_4k")])
def test_mesh_plan_takes_the_rule(arch, shape):
    """``launch/dryrun.py mesh_plan`` reckons through ``fsdp_rule``: its
    record's ``state_gb_dev`` and ``fsdp`` are the reference's inline
    arithmetic on its ``param_bytes``, bit for bit, and its params' bytes
    are under ``zero_specs`` exactly where ``fsdp`` is."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.dryrun import _sharded_bytes, mesh_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    rec = mesh_plan(cfg, INPUT_SHAPES[shape], multi_pod=False)
    state_gb_dev = rec["param_bytes"] * (1 + 8 / 2) / 16 / 1e9
    assert rec["state_gb_dev"] == state_gb_dev and rec["fsdp"] is bool(state_gb_dev > 8.0)
    mesh = make_production_mesh()
    params = init_params(cfg, device="meta", expert_slabs="device", n_model=16)
    pspecs = param_specs(cfg, params, n_model=16)
    specs = zero_specs(params, pspecs, dp="data", n_dp=16) if rec["fsdp"] else pspecs
    assert rec["bytes_per_device"]["params"] == _sharded_bytes(params, specs, mesh)


@pytest.mark.parametrize("name", ["moe", "mamba", "pattern"])
def test_rank_model_applies_the_rule_and_draws_the_slices(runs, name):
    """``launch/train.py rank_model`` on the 2 x 2 mesh: by the rule
    (``fsdp=None``) these reduced trees stay ZeRO-1 (``state_gb_dev``
    ``fsdp_rule``'s reckoning of the tree); forced on or off, the params it
    draws equal ``shard_params`` of the whole seeded tree under
    ``zero_specs`` or ``param_specs``, leaf for leaf: the MoE tree drawn whole
    and cut, Mamba2's cut leaf by leaf as drawn, the pattern stack's view
    drawn as blocks and cut."""
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.params import init_params
    cfg = scenario_cfg(name)
    kw = dict(expert_slabs="device", n_model=N_MODEL) if cfg.is_moe else {}
    gb, on = fsdp_rule(tree_bytes(init_params(cfg, device="meta", **kw)), N_MODEL)
    assert not on
    for w in runs[1]:
        assert not w[f"rank_model/{name}/auto/fsdp"]
        assert w[f"rank_model/{name}/auto/state_gb_dev"] == gb
        for mode, want in (("auto", False), ("on", True), ("off", False)):
            assert bool(w[f"rank_model/{name}/{mode}/fsdp"]) is want
            assert w[f"rank_model/{name}/{mode}/equal"], (name, mode)


def test_launcher_fsdp_json_line(runs):
    """``launch/train.py --mesh 2x2 --fsdp on`` (reduced Qwen2-MoE on the
    CPU): every rank's JSON line says ``fsdp``, the rule's ``state_gb_dev``
    and its planned bytes, the params' the ``zero_specs`` slices; its first
    loss is the one-device step's on the same seed and batch (capacity per
    data shard, one microbatch a shard)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dryrun import _sharded_bytes, tree_bytes
    from repro_torch.models.model import build
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step
    rc, out, err = runs[2]
    assert rc == 0, err[-3000:]
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    whole = init_params(cfg, device="meta", expert_slabs="device", n_model=N_MODEL)
    pspecs, zspecs = _specs(cfg, whole)
    gb, _ = fsdp_rule(tree_bytes(whole), N_MODEL)
    mesh = _mesh((N_DP, N_MODEL), (0, 0))
    for r in recs:
        assert r["fsdp"] is True and r["state_gb_dev"] == gb
        assert r["planned_bytes"] == dict(params=_sharded_bytes(whole, zspecs, mesh),
                                          moments=_sharded_bytes(whole, zspecs, mesh, 8),
                                          accumulator=_sharded_bytes(whole, zspecs, mesh, 4))
        assert r["planned_bytes"]["params"] < _sharded_bytes(whole, pspecs, mesh)
    assert "fsdp=True" in out
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("step ")]
    params = init_params(cfg, 1, "cpu", expert_slabs="device", n_model=N_MODEL)
    tokens = torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=1).batches(4, 32)))
    opt = AdamW(lr=0.0)
    m = make_train_step(build(cfg, capacity_factor=cfg.capacity_factor), opt, microbatches=2)(
        params, opt.init(params), {"tokens": tokens})[2]
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-2)


def test_launcher_refuses_an_unknown_fsdp_mode():
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--mesh", "2x2",
              "--backend", "gloo", "--fsdp", "sometimes"])
