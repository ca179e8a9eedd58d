"""The JAX package's vlm, enc-dec and static-window pattern bundles on a
forced 4-device host mesh, for tests/test_torch_mesh_families.py. Run as a
script (it must set the device count before JAX starts):

    python tests/torch_mesh_families_ref.py DIR SCENARIO

(one process a scenario, so the three compile side by side). Writes
``DIR/inputs_<scenario>.npz`` first, as soon as the params and inputs are
drawn (the params as float32 arrays under ``<scenario>/params/...``; the
train batch under ``io/tokens`` and ``io/front``, the prompt under
``io/prompt`` and ``io/front_prompt``: the vlm's ``patch_embeds`` or the
enc-dec's ``frames``, bf16 values held as float32;
tests/torch_mesh_families_world.py starts on them while this script
compiles), then ``DIR/ref_<scenario>.npz``: the forward's logits
(``io/logits``), two AdamW steps (lr 1e-3) of the jitted step with
``param_specs`` / ``zero_specs`` / ``batch_specs`` shardings (each step's
metrics, the first moment after step 1, the params after step 2), the
prefill's logits, each greedy decode step's logits (``io/logits/<t>``) and
tokens (``io/tokens_decode`` [steps, B]) under ``cache_specs`` shardings
over ``capacity(scenario)`` slots, and the whole cache's per-leaf specs
(``specs/<leaf>``, as text).

Scenarios (the same in tests/torch_mesh_families_world.py):

* ``vlm_kv1_2x2``: reduced Llama-3.2-Vision at 2 layers (one self and one
  cross layer) with ``n_kv_heads = 1`` on a 2 x 2 (data, model) mesh, the
  gates set to 0.5 / -0.7 (zero at init makes a fresh cross layer the
  identity): the 4 query heads 2 a rank, the one KV head whole, so the
  memory [.., 16, 1, 32] is sharded by its 16 patch slots, 8 a rank, and so
  is the self ring (14 slots).
* ``encdec_2x2``: reduced SeamlessM4T at 2 + 2 layers on 2 x 2, its 4 KV
  heads 2 a rank (the memory's too), ``proj`` [64, 256] by its columns.
* ``pattern_2x2``: reduced gemma3 at 7 layers under
  ``REPRO_OPT_STATIC_WINDOW`` (one pattern block of 6, one tail layer) on
  2 x 2, a prompt of 200 tokens into a 256-slot ring (its one KV head
  whole, the ring's slots 128 a rank): every local layer's 64-token window
  then lies in model rank 1's block while rank 0 holds 128 filled slots,
  none valid.

The enc-dec and the pattern stack run in f32 (every leaf cast to f32,
``PDT`` set to f32), as tests/test_torch_families.py holds its deeper
stacks: the two packages' bf16 gap there passes ``DEEP`` on one device
already (the enc-dec's forward logits at 2 + 2 layers: 0.0517 by ``_err``
on the first data shard's rows, unsharded on both sides).
"""
import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from torch_mesh_families_world import (FRONT, GATES, LR, SCENARIOS, STEPS,  # noqa: E402
                                       capacity)
from torch_mesh_ssm_ref import _f32, _mesh, _save  # noqa: E402

from repro.configs.base import get_config, reduced  # noqa: E402
from repro.launch import partition  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.model import build, pad_cache  # noqa: E402
from repro.training.optimizer import AdamW, AdamWState  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402

INPUTS = {}
OUT = {}


def scenario_cfg(name):
    import dataclasses
    arch, changes, *_ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def _front(rng, cfg, B, S, dtype):
    """The frontend's input of B rows (the vlm's patches, the enc-dec's S
    frames), bf16-rounded, or None."""
    if cfg.family not in FRONT:
        return None
    n = cfg.n_frontend_tokens if cfg.family == "vlm" else S
    a = rng.standard_normal((B, n, cfg.frontend_dim)).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16).astype(dtype)


def inputs(name):
    _, _, shape, B, S, prompt_len, f32 = SCENARIOS[name]
    cfg = scenario_cfg(name)
    params = jax.jit(build(cfg).init)(jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        cross = dict(params["blocks"]["cross"])
        for key, val in zip(("gate_attn", "gate_mlp"), GATES):
            cross[key] = jnp.full_like(cross[key], val)
        params = dict(params, blocks=dict(params["blocks"], cross=cross))
    dtype = jnp.bfloat16
    if f32:
        JM.PDT = dtype = jnp.float32
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    front, front_prompt = _front(rng, cfg, B, S, dtype), _front(rng, cfg, B, prompt_len, dtype)
    _save(INPUTS, f"{name}/params", params)
    INPUTS[f"{name}/io/tokens"] = tokens
    INPUTS[f"{name}/io/prompt"] = prompt
    if front is not None:
        INPUTS[f"{name}/io/front"] = _f32(front)
        INPUTS[f"{name}/io/front_prompt"] = _f32(front_prompt)
    return params, tokens, prompt, front, front_prompt


def _batch(cfg, tokens, front):
    batch = {"tokens": jnp.asarray(tokens)}
    if front is not None:
        batch[FRONT[cfg.family]] = front
    return batch


def scenario(name, params, tokens, prompt, front, front_prompt):
    _, _, shape, B, _, prompt_len, _ = SCENARIOS[name]
    cfg = scenario_cfg(name)
    mesh = _mesh(shape)
    bundle = build(cfg, mesh_info={"mesh": mesh, "dp": ("data",), "tp": "model"})
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    pspecs = partition.param_specs(cfg, params, n_model=shape[1])
    zspecs = partition.zero_specs(params, pspecs, dp="data", n_dp=shape[0])
    bspec = lambda batch: ns(partition.batch_specs(batch, dp="data", n_dp=shape[0]))
    batch = _batch(cfg, tokens, front)
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

    pre = _batch(cfg, prompt, front_prompt)
    logits, cache = jax.jit(bundle.prefill, in_shardings=(ns(pspecs), bspec(pre)))(params, pre)
    OUT[f"{name}/io/logits_prefill"] = _f32(logits)
    cache = pad_cache(cache, capacity(name), bundle.ring_axes)
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
    if SCENARIOS[name][0] == "gemma3_1b":
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1"
    drawn = inputs(name)
    part = os.path.join(out_dir, f"inputs_{name}.part.npz")
    np.savez(part, **INPUTS)
    os.replace(part, os.path.join(out_dir, f"inputs_{name}.npz"))
    scenario(name, *drawn)
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"), **OUT)


if __name__ == "__main__":
    main()
