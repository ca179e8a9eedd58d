"""The port's sharded MoE FFN and train step in a gloo world of 4 CPU
processes, for tests/test_torch_mesh.py: the scenarios of
tests/torch_mesh_ref.py on its params and inputs. Imports no JAX.

    python tests/torch_mesh_world.py INPUTS.npz OUT_DIR

(INPUTS.npz: the params and inputs tests/torch_mesh_ref.py writes first.)

Each rank writes ``OUT_DIR/rank<r>.npz``: its coordinates, each scenario's
outputs on this rank (its data shard, its blocks) and its router calls'
ids in call order. Beside each scenario a planted fault that the test
requires to fail:

* ``expert_fault``: the model rank 1's ``e_start`` off by one shard (it
  dispatches to rank 0's experts with its own weights);
* ``hidden_fault``: the partial outputs not summed over the model axis;
* ``train_fault``: ``copy_to`` left out (identity in both directions), so
  each rank keeps its part of the gradient of replicated weights: one step
  and its first moment.

One more scenario has no reference run: ``dense``, reduced Qwen3-1.7B with
one KV head (4 query heads: sharded over the model axis, the KV head
replicated and read by each rank's query heads; ``q_norm`` / ``k_norm``
replicated inside the sharded region; the MLP column / row parallel) on
the 2 x 2 mesh from the port's own seeded params: the forward's logits
and one step's metrics and first moment, for the test to hold against the
port's one-device step.
"""
import os
import sys
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3
DENSE_SEED = 5


def _tree(z, prefix: str) -> dict:
    """The npz entries under ``prefix/`` as a nested dict of tensors:
    bf16 but the f32 router (a ``build_dense`` tree's dtypes)."""
    out = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        path = k[len(prefix) + 1:].split("/")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = torch.from_numpy(np.array(z[k]))
        node[path[-1]] = a if path[-1] == "router" or a.dtype != torch.float32 \
            else a.to(torch.bfloat16)
    return out


def _flat(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v.detach().float().numpy()


def rank_main(rank: int, ref: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch.distributed as dist

    from repro_torch import collectives as C
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import init_rank, make_mesh, mesh_info
    from repro_torch.launch.partition import batch_specs, param_specs, shard_leaf, zero_specs
    from repro_torch.models import moe_layer as M
    from repro_torch.models.model import build
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    init_rank("gloo")
    z = np.load(ref)
    out = {}
    routes = []
    orig_route = M.route

    def route(*a):
        w, ids, probs = orig_route(*a)
        routes.append(ids.numpy().copy())
        return w, ids, probs

    M.route = route

    def keep_routes(name):
        for i, ids in enumerate(routes):
            out[f"{name}/route/{i}"] = ids
        routes.clear()

    def moe(name, cfg, shape, fault=None):
        mesh = make_mesh(shape, ("data", "model"), "gloo", "cpu")
        minfo = mesh_info(mesh)
        p = _tree(z, f"{name}/params")
        p = shard_params({"moe": p}, param_specs(cfg, {"moe": p}, n_model=shape[1]),
                         mesh)["moe"]
        x = torch.from_numpy(z[f"{name}/io/x"]).to(torch.bfloat16)
        x = shard_leaf(x, batch_specs({"x": x}, dp="data", n_dp=shape[0])["x"], mesh)
        out[f"{name}/coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
        y, aux = M.moe_ffn(x, p, cfg, mesh_info=minfo)
        out[f"{name}/y"], out[f"{name}/aux"] = y.float().numpy(), float(aux)
        keep_routes(name)
        if fault is not None:
            with fault(mesh):
                out[f"{name}_fault/y"] = M.moe_ffn(x, p, cfg, mesh_info=minfo)[0].float().numpy()
            routes.clear()

    class Patch:
        def __init__(self, obj, name, value):
            self.obj, self.name, self.value = obj, name, value

        def __enter__(self):
            self.old = getattr(self.obj, self.name)
            setattr(self.obj, self.name, self.value)

        def __exit__(self, *exc):
            setattr(self.obj, self.name, self.old)

    def e_start_off(mesh):
        one = mesh.coords["model"] == 1
        return Patch(M, "expert_start", lambda mode, i, e_loc: (i - one) * e_loc)

    expert_cfg = reduced(get_config("qwen2_moe_a2_7b"))
    hidden_cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")), n_experts=2, top_k=1)
    moe("expert", expert_cfg, (2, 2), e_start_off)
    moe("hidden", hidden_cfg, (1, 4), lambda mesh: Patch(C, "reduce_from", lambda x, ax: x))

    # the train step on the 2 x 2 mesh
    cfg = expert_cfg
    mesh = make_mesh((2, 2), ("data", "model"), "gloo", "cpu")
    minfo = mesh_info(mesh)
    bundle = build(cfg, mesh_info=minfo)
    whole = _tree(z, "train/params0")
    pspecs = param_specs(cfg, whole, n_model=2)
    zspecs = zero_specs(whole, pspecs, dp="data", n_dp=2)
    tokens = torch.from_numpy(z["train/io/tokens"]).long()
    tokens = shard_leaf(tokens, batch_specs({"t": tokens}, dp="data", n_dp=2)["t"], mesh)
    out["train/coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
    params = shard_params(whole, pspecs, mesh)
    with torch.no_grad():
        logits, aux = bundle.forward(params, {"tokens": tokens})
    out["train/logits"], out["train/aux"] = logits.float().numpy(), float(aux)
    keep_routes("train")

    def run(params, steps, name):
        opt = ZeRO1(AdamW(lr=LR), pspecs, zspecs, minfo)
        state = opt.init(params)
        step = make_train_step(bundle, opt)
        for i in range(steps):
            params, state, m = step(params, state, {"tokens": tokens})
            for k, v in m.items():
                out[f"{name}/metrics{i}/{k}"] = float(v)
            if i == 0:
                for j, t in enumerate(tree_leaves(state.m)):
                    out[f"{name}/m0/{j}"] = t.numpy().copy()
        routes.clear()
        return params

    C.reset()
    _flat(run(params, 2, "train"), "train/params2", out)
    for op, r in C.record().items():
        out[f"train/collectives/{op}"] = np.array([r["count"], r["bytes"]])
    with Patch(C, "copy_to", lambda x, ax: x):
        run(shard_params(whole, pspecs, mesh), 1, "train_fault")

    cfg = dataclasses.replace(reduced(get_config("qwen3_1_7b")), n_kv_heads=1)
    bundle = build(cfg, mesh_info=minfo)
    whole = init_params(cfg, DENSE_SEED, "cpu", expert_slabs="device", n_model=2)
    pspecs = param_specs(cfg, whole, n_model=2)
    zspecs = zero_specs(whole, pspecs, dp="data", n_dp=2)
    params = shard_params(whole, pspecs, mesh)
    with torch.no_grad():
        out["dense/logits"] = bundle.forward(params, {"tokens": tokens})[0].float().numpy()
    run(params, 1, "dense")
    M.route = orig_route
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def main():
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import spawn
    spawn(rank_main, (sys.argv[1], sys.argv[2],), 4)


if __name__ == "__main__":
    main()
