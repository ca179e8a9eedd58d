"""The JAX package's sharded prefill and decode on a forced 4-device host
mesh, for tests/test_torch_mesh_decode.py. Run as a script (it must set the
device count before JAX starts):

    python tests/torch_mesh_decode_ref.py INPUTS.npz OUT.npz

Writes INPUTS.npz first, as soon as the params are drawn (each scenario's
params as float32 arrays under ``<scenario>/params/...`` and its prompt
under ``<scenario>/io/prompt``; tests/torch_mesh_decode_world.py starts on
it while this script compiles), then OUT.npz: each scenario's prefill
logits (``io/logits_prefill``), each decode step's logits
(``io/logits/<t>``) and greedy tokens (``io/tokens`` [steps, B]), the
whole cache's per-leaf specs (``specs/<leaf>``, as text) and every router
call's ids and probabilities per (data, model) shard in call order
(``route/<data>_<model>/<i>/ids|probs``).

The steps are the reference's serving path on a mesh: ``jax.jit(prefill,
in_shardings=(param_specs, batch_specs))``, ``pad_cache`` to
the scenario's capacity, then ``jax.jit(decode_step, in_shardings=(param_specs,
batch_specs, cache_specs))`` for ``STEPS`` greedy tokens (the argmax over
the real vocabulary). The MoE FFN runs under ``REPRO_MOE_PALLAS=1`` (the
Pallas ``expert_ffn`` in interpret mode: the port's kernel arithmetic).

Scenarios (the same in tests/torch_mesh_decode_world.py):

* ``qwen_2x2``: reduced Qwen2-MoE-A2.7B (4 KV heads: heads sharded) on a 2
  x 2 (data, model) mesh, B = 4.
* ``granite_2x2``: reduced Granite-34B (MQA, one KV head: slots sharded, 8
  a rank) on the 2 x 2 mesh, B = 4.
* ``granite_1x4``: the same on a 1 x 4 mesh (4 slots a rank), B = 2.
* ``granite_2x2_w15``: the 2 x 2 mesh with a 15-slot ring: neither its
  one KV head nor its slots divide the model axis, so the cache is
  replicated over it.

A prompt of ``PROMPT`` tokens fills slots 0-5; step t writes position 6 +
t at slot (6 + t) % 16, so the writes cross every block boundary and wrap
the ring at step 10 (at step 9 in the 15-slot ring).
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import get_config, reduced  # noqa: E402
from repro.launch import partition  # noqa: E402
from repro.models import moe_layer as JM  # noqa: E402
from repro.models.model import build, pad_cache  # noqa: E402

PROMPT, STEPS = 6, 14
SCENARIOS = {"qwen_2x2": ("qwen2_moe_a2_7b", (2, 2), 4, 16),    # (arch, mesh, B, capacity)
             "granite_2x2": ("granite_34b", (2, 2), 4, 16),
             "granite_1x4": ("granite_34b", (1, 4), 2, 16),
             "granite_2x2_w15": ("granite_34b", (2, 2), 4, 15)}
INPUTS = {}
OUT = {}
ROUTES = {}
_orig_route = JM.route


def _route(x2d, router, n_real, top_k):
    out = _orig_route(x2d, router, n_real, top_k)

    def keep(ids, probs, d, m):
        ROUTES.setdefault((int(d), int(m)), []).append((np.asarray(ids), np.asarray(probs)))
    jax.debug.callback(keep, out[1], out[2], lax.axis_index("data"), lax.axis_index("model"))
    return out


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


def _minfo(shape):
    return {"mesh": _mesh(shape), "dp": ("data",), "tp": "model"}


def inputs(name, drawn):
    """(params, prompt) of a scenario; a dense config's params do not
    depend on the mesh, so a scenario reuses an earlier one's of its arch."""
    arch, shape, B, _ = SCENARIOS[name]
    cfg = reduced(get_config(arch))
    same = [p for n, (p, _) in drawn.items() if SCENARIOS[n][0] == arch and not cfg.is_moe]
    params = same[0] if same else jax.jit(build(cfg, mesh_info=_minfo(shape)).init)(
        jax.random.PRNGKey(0))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    _save(INPUTS, f"{name}/params", params)
    INPUTS[f"{name}/io/prompt"] = prompt
    return params, prompt


def scenario(name, params, prompt):
    arch, shape, B, capacity = SCENARIOS[name]
    cfg = reduced(get_config(arch))
    minfo = _minfo(shape)
    mesh = minfo["mesh"]
    bundle = build(cfg, mesh_info=minfo)
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    pspecs = ns(partition.param_specs(cfg, params, n_model=shape[1]))
    batch = {"tokens": jnp.asarray(prompt)}
    bspecs = ns(partition.batch_specs(batch, dp="data", n_dp=shape[0]))
    logits, cache = jax.jit(bundle.prefill, in_shardings=(pspecs, bspecs))(params, batch)
    OUT[f"{name}/io/logits_prefill"] = _f32(logits)
    cache = pad_cache(cache, capacity, bundle.ring_axes)
    cspecs = partition.cache_specs(cfg, cache, dp="data", n_model=shape[1], n_dp=shape[0])
    for key, spec in cspecs.items():
        OUT[f"{name}/specs/{key}"] = np.array(repr(tuple(spec)))
    step = {"token": jnp.zeros((B, 1), jnp.int32)}
    sspecs = ns(partition.batch_specs(step, dp="data", n_dp=shape[0]))
    decode = jax.jit(bundle.decode_step, in_shardings=(pspecs, sspecs, ns(cspecs)))
    tokens = []
    for t in range(STEPS):
        tok = jnp.argmax(logits[:, :cfg.vocab].astype(jnp.float32), -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
        # the step's outputs leave it in the shardings GSPMD chose
        cache = jax.device_put(cache, ns(cspecs))
        logits, cache = decode(params, {"token": tok}, cache)
        OUT[f"{name}/io/logits/{t}"] = _f32(logits)
    OUT[f"{name}/io/tokens"] = np.stack(tokens)
    jax.effects_barrier()
    for (d, m), calls in sorted(ROUTES.items()):
        for i, (ids, probs) in enumerate(calls):
            OUT[f"{name}/route/{d}_{m}/{i}/ids"] = ids
            OUT[f"{name}/route/{d}_{m}/{i}/probs"] = probs
    ROUTES.clear()


def main():
    inputs_path, out_path = sys.argv[1], sys.argv[2]
    drawn = {}
    for name in SCENARIOS:
        drawn[name] = inputs(name, drawn)
    np.savez(inputs_path + ".part.npz", **INPUTS)
    os.replace(inputs_path + ".part.npz", inputs_path)
    JM.route = _route
    os.environ["REPRO_MOE_PALLAS"] = "1"
    for name in SCENARIOS:
        scenario(name, *drawn[name])
    np.savez(out_path, **OUT)


if __name__ == "__main__":
    main()
