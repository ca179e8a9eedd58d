"""The JAX package's sharded MoE FFN and train step on a forced 4-device
host mesh, for tests/test_torch_mesh.py. Run as a script (it must set the
device count before JAX starts):

    python tests/torch_mesh_ref.py INPUTS.npz OUT.npz

Writes INPUTS.npz first, as soon as the params are drawn (each scenario's
params as float32 arrays and its inputs under ``<scenario>/params/...`` and
``<scenario>/io/...``; tests/torch_mesh_world.py starts on it while this
script compiles), then OUT.npz: the outputs under ``<scenario>/<name>`` and
every router call's ids and probabilities per (data, model) shard in call
order (``<scenario>/route/<data>_<model>/<i>/ids|probs``).

Scenarios (the same in tests/torch_mesh_world.py):

* ``expert``: reduced Qwen2-MoE-A2.7B's MoE FFN (4 experts, top-2, one
  shared expert) on a 2 x 2 (data, model) mesh, x [4, 16, 256].
* ``hidden``: reduced Mixtral-8x7B with 2 experts, top-1, on a 1 x 4 mesh
  (E < n_model: every expert's hidden dim over the model axis), x [2, 16,
  256].
The MoE FFN runs under ``REPRO_MOE_PALLAS=1`` (the Pallas ``expert_ffn`` in
interpret mode: the port's kernel arithmetic) but in the train steps, which
differentiate it (the einsum path).

* ``train``: reduced Qwen2-MoE-A2.7B's bundle on the 2 x 2 mesh: the
  forward's logits of tokens [4, 32], then two AdamW steps (lr 1e-3) of the
  jitted step with ``param_specs`` / ``zero_specs`` / ``batch_specs``
  shardings: each step's metrics, the first moment after step 1, the
  params after step 2.
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import get_config, reduced  # noqa: E402
from repro.launch import partition  # noqa: E402
from repro.models import moe_layer as JM  # noqa: E402
from repro.models.model import build  # noqa: E402
from repro.training.optimizer import AdamW, AdamWState  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402

LR = 1e-3
INPUTS = {}
OUT = {}
ROUTES = {}


def expert_cfg():
    return reduced(get_config("qwen2_moe_a2_7b"))


def hidden_cfg():
    return dataclasses.replace(reduced(get_config("mixtral_8x7b")), n_experts=2, top_k=1)


def _route(x2d, router, n_real, top_k):
    out = _orig_route(x2d, router, n_real, top_k)

    def keep(ids, probs, d, m):
        ROUTES.setdefault((int(d), int(m)), []).append((np.asarray(ids), np.asarray(probs)))
    jax.debug.callback(keep, out[1], out[2], lax.axis_index("data"), lax.axis_index("model"))
    return out


_orig_route = JM.route


def _save(scenario, tree, prefix, into=None):
    into = OUT if into is None else into
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        into[f"{scenario}/{prefix}/{name}"] = np.asarray(jnp.asarray(leaf, jnp.float32)
                                                         if leaf.dtype == jnp.bfloat16 else leaf)


def _routes(scenario):
    jax.effects_barrier()
    for (d, m), calls in sorted(ROUTES.items()):
        for i, (ids, probs) in enumerate(calls):
            OUT[f"{scenario}/route/{d}_{m}/{i}/ids"] = ids
            OUT[f"{scenario}/route/{d}_{m}/{i}/probs"] = probs
    ROUTES.clear()


def _mesh(shape):
    """A (data, model) host mesh whose shardings GSPMD propagates (the
    reference's meshes predate explicit-axis meshes)."""
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16)


def moe_inputs(name, cfg, shape, x_shape):
    p = JM.moe_params(jax.random.PRNGKey(1), cfg, n_model=shape[1])
    x = _x(x_shape, 2)
    _save(name, p, "params", INPUTS)
    _save(name, {"x": x}, "io", INPUTS)
    return p, x


def moe_scenario(name, cfg, shape, p, x):
    mesh = _mesh(shape)
    minfo = {"mesh": mesh, "dp": ("data",), "tp": "model"}
    y, aux = jax.jit(lambda x, p: JM.moe_ffn(x, p, cfg, mesh_info=minfo))(x, p)
    _save(name, {"y": y, "aux": aux}, "io")
    _routes(name)


def train_inputs():
    cfg = expert_cfg()
    bundle = build(cfg, mesh_info={"mesh": _mesh((2, 2)), "dp": ("data",), "tp": "model"})
    params = bundle.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(np.random.default_rng(3).integers(0, cfg.vocab, (4, 32)), jnp.int32)
    _save("train", params, "params0", INPUTS)
    _save("train", {"tokens": tokens}, "io", INPUTS)
    return params, tokens


def train_scenario(params, tokens):
    cfg = expert_cfg()
    mesh = _mesh((2, 2))
    minfo = {"mesh": mesh, "dp": ("data",), "tp": "model"}
    bundle = build(cfg, mesh_info=minfo)
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    pspecs = partition.param_specs(cfg, params, n_model=2)
    zspecs = partition.zero_specs(params, pspecs, dp="data", n_dp=2)
    batch = {"tokens": tokens}
    bspecs = partition.batch_specs(batch, dp="data", n_dp=2)
    logits, aux = jax.jit(bundle.forward, in_shardings=(ns(pspecs), ns(bspecs)))(params, batch)
    _save("train", {"logits": logits, "aux": aux}, "io")
    _routes("train")
    os.environ.pop("REPRO_MOE_PALLAS")   # the step differentiates the einsum path
    opt = AdamW(lr=LR)
    step = jax.jit(make_train_step(bundle, opt),
                   in_shardings=(ns(pspecs), ns(AdamWState(P(), zspecs, zspecs)), ns(bspecs)))
    state = opt.init(params)
    for i in range(2):
        # the step's outputs leave it in the shardings GSPMD chose
        params = jax.device_put(params, ns(pspecs))
        state = jax.device_put(state, ns(AdamWState(P(), zspecs, zspecs)))
        params, state, m = step(params, state, batch)
        _save("train", {k: v for k, v in m.items()}, f"metrics{i}")
        if i == 0:
            _save("train", state.m, "m0")
    _save("train", params, "params2")
    ROUTES.clear()


def main():
    inputs_path, out_path = sys.argv[1], sys.argv[2]
    cases = {"expert": (expert_cfg(), (2, 2), (4, 16, 256)),
             "hidden": (hidden_cfg(), (1, 4), (2, 16, 256))}
    drawn = {name: moe_inputs(name, *case) for name, case in cases.items()}
    train = train_inputs()
    np.savez(inputs_path + ".part.npz", **INPUTS)
    os.replace(inputs_path + ".part.npz", inputs_path)
    JM.route = _route
    # the expert FFN through the Pallas kernel in interpret mode (the port's
    # kernel arithmetic) where nothing is differentiated
    os.environ["REPRO_MOE_PALLAS"] = "1"
    for name, (cfg, shape, _) in cases.items():
        moe_scenario(name, cfg, shape, *drawn[name])
    train_scenario(*train)
    np.savez(out_path, **OUT)


if __name__ == "__main__":
    main()
