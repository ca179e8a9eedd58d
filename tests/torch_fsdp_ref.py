"""The JAX package's FSDP train step on a forced 4-device host mesh, for
tests/test_torch_fsdp.py: the reference dry-run's FSDP branch
(``repro.launch.dryrun``, where ``state_gb_dev`` passes 8 GB), run for
real at reduced widths. Run as a script (it must set the device count
before JAX starts):

    python tests/torch_fsdp_ref.py DIR SCENARIO

(one process a scenario, so they compile side by side). Writes
``DIR/inputs_<scenario>.npz`` first, as soon as the params are drawn (the
params as float32 arrays under ``<scenario>/params/...``, the tokens under
``<scenario>/io/tokens``; tests/torch_fsdp_world.py starts on it while
this script compiles), then ``DIR/ref_<scenario>.npz``: the f32
scenario's forward logits with the params under ``zero_specs``
(``io/logits``), then two
AdamW steps (lr 1e-3) of the jitted ``make_train_step`` as the dry-run
builds it: params and moments under ``zero_specs``, the batch under
``batch_specs``, ``MICROBATCHES`` microbatches each pinned to the data
axes, the f32 accumulator pinned to ``zero_specs``; each step's metrics,
the first moment after step 1 and the params after step 2; for a
scenario of ``F32_WITNESS`` then the forward's logits with every leaf
cast to f32 and ``PDT`` f32, under ``zero_specs`` (``io/logits_f32``).

Scenarios (the same in tests/torch_fsdp_world.py), each on a 2 x 2 (data,
model) mesh, B = 4 x 32 tokens:

* ``moe``: reduced Qwen2-MoE-A2.7B (the draws of tests/torch_mesh_ref.py's
  ``train`` scenario);
* ``mamba``: reduced Mamba2-2.7B at its 2 layers, whose ``A_log``, ``D``,
  ``dt_bias`` [2, 32] and ``norm`` [2, 512] take the data axes on the
  layer dim (the other dim is the model axis'); these leaves, one fill in
  every layer as drawn, get 0.1 of a normal draw added (``LAYER_FILLS``,
  every Mamba scenario), so that a layer read from another layer's slice
  shows;
* ``zamba``: reduced Zamba2-7B at 3 layers (a block of 2 Mamba layers, the
  shared attention block, unstacked, and a Mamba tail layer) in f32: every
  leaf cast to f32 and ``repro.models.model.PDT`` set to f32, as
  tests/torch_mesh_ssm_ref.py runs it.
"""
import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import get_config, reduced  # noqa: E402
from repro.launch import partition  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.model import build  # noqa: E402
from repro.training.optimizer import AdamW, AdamWState  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402

LR = 1e-3
MESH = (2, 2)
B, S = 4, 32
MICROBATCHES = 2          # the dry-run's min(4, global batch / data ranks)
# scenario -> (arch, config changes, every leaf and activation in f32)
SCENARIOS = {"moe": ("qwen2_moe_a2_7b", {}, False),
             "mamba": ("mamba2_2_7b", {}, False),
             "zamba": ("zamba2_7b", {"n_layers": 3}, True)}
LAYER_FILLS = ("A_log", "D", "dt_bias", "norm")
# bf16 scenarios whose forward also runs in f32 (every leaf cast, PDT f32)
F32_WITNESS = ("mamba",)
INPUTS = {}
OUT = {}


def scenario_cfg(name):
    arch, changes, _ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def _f32(leaf):
    return np.asarray(jnp.asarray(leaf, jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)


def _save(into, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        into[f"{prefix}/{name}"] = _f32(leaf)


def _mesh():
    """A (data, model) host mesh whose shardings GSPMD propagates (the
    reference's meshes predate explicit-axis meshes)."""
    return jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def inputs(name):
    cfg = scenario_cfg(name)
    mesh = _mesh()
    bundle = build(cfg, mesh_info={"mesh": mesh, "dp": ("data",), "tp": "model"})
    params = bundle.init(jax.random.PRNGKey(0))
    # the Mamba layers' per-channel leaves start as one fill in every layer,
    # under which a layer read from the wrong rank's slice would not show:
    # each gets its own values
    keys = iter(jax.random.split(jax.random.PRNGKey(5), 64))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + (0.1 * jax.random.normal(next(keys), a.shape)).astype(a.dtype)
        if str(getattr(path[-1], "key", "")) in LAYER_FILLS else a, params)
    if SCENARIOS[name][2]:
        JM.PDT = jnp.float32
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    _save(INPUTS, f"{name}/params", params)
    INPUTS[f"{name}/io/tokens"] = tokens
    return params, tokens


def scenario(name, params, tokens):
    cfg = scenario_cfg(name)
    mesh = _mesh()
    bundle = build(cfg, mesh_info={"mesh": mesh, "dp": ("data",), "tp": "model"})
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    n_dp = MESH[0]
    pspecs = partition.param_specs(cfg, params, n_model=MESH[1])
    zspecs = partition.zero_specs(params, pspecs, dp="data", n_dp=n_dp)
    batch = {"tokens": jnp.asarray(tokens)}
    bspecs = partition.batch_specs(batch, dp="data", n_dp=n_dp)
    if SCENARIOS[name][2]:     # the test holds the f32 scenario's logits only
        logits, _ = jax.jit(bundle.forward, in_shardings=(ns(zspecs), ns(bspecs)))(params, batch)
        OUT[f"{name}/io/logits"] = _f32(logits)

    # the dry-run's FSDP branch (src/repro/launch/dryrun.py): params and
    # moments under zero_specs, each microbatch pinned to the data axes,
    # the accumulator to zero_specs
    def mb_constraint(tree):
        def pin(leaf):
            spec = [None] * leaf.ndim
            if leaf.shape[0] % n_dp == 0:
                spec[0] = "data"
            return jax.lax.with_sharding_constraint(leaf, NamedSharding(mesh, P(*spec)))
        return jax.tree.map(pin, tree)

    def acc_constraint(tree):
        return jax.tree.map(lambda leaf, sp: jax.lax.with_sharding_constraint(
            leaf, NamedSharding(mesh, sp)), tree, zspecs)

    opt = AdamW(lr=LR)
    ospecs = AdamWState(P(), zspecs, zspecs)
    step = jax.jit(make_train_step(bundle, opt, microbatches=MICROBATCHES,
                                   mb_constraint=mb_constraint, acc_constraint=acc_constraint),
                   in_shardings=(ns(zspecs), ns(ospecs), ns(bspecs)))
    state = opt.init(params)
    p = params
    for i in range(2):
        # the step's outputs leave it in the shardings GSPMD chose
        p = jax.device_put(p, ns(zspecs))
        state = jax.device_put(state, ns(ospecs))
        p, state, m = step(p, state, batch)
        _save(OUT, f"{name}/metrics{i}", dict(m))
        if i == 0:
            _save(OUT, f"{name}/m0", state.m)
    _save(OUT, f"{name}/params2", p)
    if name in F32_WITNESS:
        JM.PDT = jnp.float32
        exact = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        logits, _ = jax.jit(bundle.forward, in_shardings=(ns(zspecs), ns(bspecs)))(exact, batch)
        OUT[f"{name}/io/logits_f32"] = _f32(logits)
        JM.PDT = jnp.bfloat16


def main():
    out_dir, name = sys.argv[1], sys.argv[2]
    drawn = inputs(name)
    part = os.path.join(out_dir, f"inputs_{name}.part.npz")
    np.savez(part, **INPUTS)
    os.replace(part, os.path.join(out_dir, f"inputs_{name}.npz"))
    scenario(name, *drawn)
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"), **OUT)


if __name__ == "__main__":
    main()
