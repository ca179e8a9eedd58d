"""The JAX package's ssm and hybrid bundles on a forced 4-device host mesh,
for tests/test_torch_mesh_ssm.py. Run as a script (it must set the device
count before JAX starts):

    python tests/torch_mesh_ssm_ref.py DIR SCENARIO

(one process a scenario, so the three compile side by side). Writes
``DIR/inputs_<scenario>.npz`` first, as soon as the params are drawn (the
params as float32 arrays under ``<scenario>/params/...``, the train
tokens and the prompt under ``<scenario>/io/tokens`` and ``io/prompt``;
tests/torch_mesh_ssm_world.py starts on it while this script compiles),
then ``DIR/ref_<scenario>.npz``: the forward's logits (``io/logits``), two
AdamW steps (lr 1e-3) of the jitted step with ``param_specs`` /
``zero_specs`` / ``batch_specs`` shardings (each step's metrics, the
first moment after step 1, the params after step 2), the prefill's
logits, each greedy decode step's logits (``io/logits/<t>``) and tokens
(``io/tokens_decode`` [steps, B]) under ``cache_specs`` shardings, and the
whole cache's per-leaf specs (``specs/<leaf>``, as text).

Scenarios (the same in tests/torch_mesh_ssm_world.py):

* ``mamba_2x2``: reduced Mamba2-2.7B (32 heads, G = 1, N = 16) on a 2 x 2
  (data, model) mesh, B = 4, prompt 8.
* ``mamba_g2_1x4``: the same with ``ssm_groups = 2`` on a 1 x 4 mesh
  (each rank's 8 heads in one group), B = 2.
* ``zamba_2x2``: reduced Zamba2-7B at 3 layers (a block of 2 Mamba layers,
  the shared attention block, a Mamba tail layer) on the 2 x 2 mesh, B = 4,
  a prompt of 70 tokens past its 64-token window (the ring wraps), with
  every leaf cast to f32 and ``repro.models.model.PDT`` set to f32: the
  two packages' bf16 gap at three layers of this stack already passes
  the test's bf16 tolerance on one device (tests/test_torch_families.py
  holds its deeper stacks in f32 for that reason).
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
from repro.models.model import build, pad_cache  # noqa: E402
from repro.training.optimizer import AdamW, AdamWState  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402

LR = 1e-3
STEPS = 6
SCENARIOS = {"mamba_2x2": ("mamba2_2_7b", {}, (2, 2), 4, 32, 8, False),
             "mamba_g2_1x4": ("mamba2_2_7b", {"ssm_groups": 2}, (1, 4), 2, 32, 8, False),
             "zamba_2x2": ("zamba2_7b", {"n_layers": 3}, (2, 2), 4, 32, 70, True)}
INPUTS = {}
OUT = {}


def scenario_cfg(name):
    arch, changes, *_ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def _f32(leaf):
    return np.asarray(jnp.asarray(leaf, jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)


def _save(into, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        into[f"{prefix}/{name}"] = _f32(leaf)


def _mesh(shape):
    """A (data, model) host mesh whose shardings GSPMD propagates (the
    reference's meshes predate explicit-axis meshes)."""
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def inputs(name):
    _, _, shape, B, S, prompt_len, f32 = SCENARIOS[name]
    cfg = scenario_cfg(name)
    params = jax.jit(build(cfg).init)(jax.random.PRNGKey(0))
    if f32:
        JM.PDT = jnp.float32
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    _save(INPUTS, f"{name}/params", params)
    INPUTS[f"{name}/io/tokens"] = tokens
    INPUTS[f"{name}/io/prompt"] = prompt
    return params, tokens, prompt


def scenario(name, params, tokens, prompt):
    _, _, shape, B, _, prompt_len, _ = SCENARIOS[name]
    cfg = scenario_cfg(name)
    mesh = _mesh(shape)
    bundle = build(cfg, mesh_info={"mesh": mesh, "dp": ("data",), "tp": "model"})
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    pspecs = partition.param_specs(cfg, params, n_model=shape[1])
    zspecs = partition.zero_specs(params, pspecs, dp="data", n_dp=shape[0])
    bspec = lambda batch: ns(partition.batch_specs(batch, dp="data", n_dp=shape[0]))
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _ = jax.jit(bundle.forward, in_shardings=(ns(pspecs), bspec(batch)))(params, batch)
    OUT[f"{name}/io/logits"] = _f32(logits)

    opt = AdamW(lr=LR)
    step = jax.jit(make_train_step(bundle, opt),
                   in_shardings=(ns(pspecs), ns(AdamWState(P(), zspecs, zspecs)), bspec(batch)))
    state = opt.init(params)
    p = params
    for i in range(2):
        # the step's outputs leave it in the shardings GSPMD chose
        p = jax.device_put(p, ns(pspecs))
        state = jax.device_put(state, ns(AdamWState(P(), zspecs, zspecs)))
        p, state, m = step(p, state, batch)
        _save(OUT, f"{name}/metrics{i}", dict(m))
        if i == 0:
            _save(OUT, f"{name}/m0", state.m)
    _save(OUT, f"{name}/params2", p)

    pre = {"tokens": jnp.asarray(prompt)}
    logits, cache = jax.jit(bundle.prefill, in_shardings=(ns(pspecs), bspec(pre)))(params, pre)
    OUT[f"{name}/io/logits_prefill"] = _f32(logits)
    W = min(prompt_len, cfg.sliding_window or prompt_len)
    cache = pad_cache(cache, W, bundle.ring_axes)
    cspecs = partition.cache_specs(cfg, cache, dp="data", n_model=shape[1], n_dp=shape[0])
    for key, spec in cspecs.items():
        OUT[f"{name}/specs/{key}"] = np.array(repr(tuple(spec)))
    tok_spec = bspec({"token": jnp.zeros((B, 1), jnp.int32)})
    decode = jax.jit(bundle.decode_step, in_shardings=(ns(pspecs), tok_spec, ns(cspecs)))
    toks = []
    for t in range(STEPS):
        tok = jnp.argmax(logits[:, :cfg.vocab].astype(jnp.float32), -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
        cache = jax.device_put(cache, ns(cspecs))
        logits, cache = decode(params, {"token": tok}, cache)
        OUT[f"{name}/io/logits/{t}"] = _f32(logits)
    OUT[f"{name}/io/tokens_decode"] = np.stack(toks)


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
