"""The JAX package's sharded forward and train step with
``REPRO_OPT_SEQ_PARALLEL=1`` (the reference's sequence-parallel pin) on
tests/torch_mesh_ref.py's forced 4-device host mesh, for
tests/test_torch_seq_parallel.py. Run as a script, one process a case (it
must set the device count before JAX starts):

    python tests/torch_seq_parallel_ref.py DIR CASE

Writes ``DIR/inputs_<case>.npz`` first, as soon as the params and inputs
are drawn (the params as float32 arrays under ``<case>/params/...``, the
tokens under ``<case>/io/tokens``, the vlm's patches, bf16 values held as
float32, under ``<case>/io/front``; tests/torch_seq_parallel_world.py
starts on them while this script compiles), then ``DIR/ref_<case>.npz``:
the jitted forward's logits under ``param_specs`` / ``batch_specs``
shardings (``<case>/io/logits``; the MoE through the Pallas ``expert_ffn``
in interpret mode, the port's kernel arithmetic, and every router call's
ids and probabilities per (data, model) shard, as tests/torch_mesh_ref.py
records them), then one AdamW step (lr 1e-3) of the jitted step with
``zero_specs`` moments: its metrics, the first moment and the params after
it.

The cases (tests/torch_seq_parallel_world.py ``CASES``): reduced
Qwen2-MoE-A2.7B, Qwen3-1.7B, gemma3-1b at 6 layers (one block) through the pattern
stack (``REPRO_OPT_STATIC_WINDOW``) and Llama-3.2-Vision at 4 layers (two
blocks of a self and a cross layer, the gates 0.5 / -0.7), each on a 2 x 2
(data, model) mesh; the last two in f32 (every leaf and activation), as
tests/test_torch_mesh_families.py holds them.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ref as R  # noqa: E402  (sets the host device count first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from torch_seq_parallel_world import CASES, GATES, LR, MESH  # noqa: E402

from repro.configs.base import get_config, reduced  # noqa: E402
from repro.launch import partition  # noqa: E402
from repro.models import model as JMODEL  # noqa: E402
from repro.models import moe_layer as JM  # noqa: E402
from repro.models.model import build  # noqa: E402
from repro.training.optimizer import AdamW, AdamWState  # noqa: E402
from repro.training.train_loop import make_train_step  # noqa: E402


def case_cfg(name):
    import dataclasses
    arch, changes, *_ = CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def main():
    out_dir, name = sys.argv[1], sys.argv[2]
    arch, _, B, S, f32 = CASES[name]
    os.environ["REPRO_OPT_SEQ_PARALLEL"] = "1"
    if arch == "gemma3_1b":
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1"
    cfg = case_cfg(name)
    params = jax.jit(build(cfg).init)(jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        cross = dict(params["blocks"]["cross"])
        for key, val in zip(("gate_attn", "gate_mlp"), GATES):
            cross[key] = jnp.full_like(cross[key], val)
        params = dict(params, blocks=dict(params["blocks"], cross=cross))
    dtype = jnp.bfloat16
    if f32:
        JMODEL.PDT = dtype = jnp.float32
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(3)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    inputs = {f"{name}/io/tokens": np.asarray(batch["tokens"])}
    if cfg.family == "vlm":
        a = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        batch["patch_embeds"] = jnp.asarray(a).astype(jnp.bfloat16).astype(dtype)
        inputs[f"{name}/io/front"] = np.asarray(batch["patch_embeds"].astype(jnp.float32))
    R._save(name, params, "params", inputs)
    part = os.path.join(out_dir, f"inputs_{name}.part.npz")
    np.savez(part, **inputs)
    os.replace(part, os.path.join(out_dir, f"inputs_{name}.npz"))

    mesh = R._mesh(MESH)
    bundle = build(cfg, mesh_info={"mesh": mesh, "dp": ("data",), "tp": "model"})
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    pspecs = partition.param_specs(cfg, params, n_model=MESH[1])
    zspecs = partition.zero_specs(params, pspecs, dp="data", n_dp=MESH[0])
    bspecs = ns(partition.batch_specs(batch, dp="data", n_dp=MESH[0]))
    if cfg.is_moe:
        JM.route = R._route
        os.environ["REPRO_MOE_PALLAS"] = "1"
    logits, _ = jax.jit(bundle.forward, in_shardings=(ns(pspecs), bspecs))(params, batch)
    R.OUT[f"{name}/io/logits"] = np.asarray(logits.astype(jnp.float32))
    if cfg.is_moe:
        R._routes(name)
        os.environ.pop("REPRO_MOE_PALLAS")   # the step differentiates the einsum path
        JM.route = R._orig_route
    opt = AdamW(lr=LR)
    step = jax.jit(make_train_step(bundle, opt),
                   in_shardings=(ns(pspecs), ns(AdamWState(P(), zspecs, zspecs)), bspecs))
    p, state, m = step(params, opt.init(params), batch)
    R._save(name, dict(m), "metrics0")
    R._save(name, state.m, "m0")
    R._save(name, p, "params1")
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"), **R.OUT)


if __name__ == "__main__":
    main()
