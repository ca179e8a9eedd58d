"""The port's sequence parallelism (``REPRO_OPT_SEQ_PARALLEL``) in a gloo
world of 4 CPU processes, for tests/test_torch_seq_parallel.py: the cases
of tests/torch_seq_parallel_ref.py on its params and inputs, each with the
flag on and off. Imports no JAX.

    python tests/torch_seq_parallel_world.py DIR

(``DIR/inputs_<case>.npz``: the params and inputs the reference writes
first; each rank waits for a case's before running it, so the world may
start beside the reference.)

Each rank writes ``DIR/rank<r>.npz``, for each case and each flag setting
(``<case>/sp`` on, ``<case>/nosp`` off): its coordinates, the forward's
logits (its data shard, its vocabulary block) and the collectives it made
(``.../count/<op>``, ``collectives.record``), the same for the sequence cut
to ``S - 1`` tokens, which the model axis does not divide (``.../odd``),
the prefill's last logits and cache (``.../prefill/...``), and one ZeRO-1
AdamW step (lr 1e-3): its metrics, the first moment, the
params after it (the rank's blocks). The MoE case records the port's
router calls (``<case>/sp/route/<i>``), and runs once more with the flag
on under FSDP (``<case>/fsdp``: the params its ``zero_specs`` slices,
gathered a layer at a time inside the layer's checkpoint): the forward's
logits and one step. An f32 case runs with
``models/layers.py PDT`` set to f32 on its f32 params. Then, with the flag
on, the planted faults' steps (their first moments), which the test
requires to fail:

* ``norm_unsummed`` (dense): the norms' weights not entering through
  ``copy_to`` (``models/model.py _norm_w``), so their gradients stay each
  rank's part;
* ``cross_rs`` (vlm): the gather of the sequence into the cross layer,
  replicated compute, with ``gather_seq``'s reduce-scatter backward
  (``models/model.py _gather_whole``): the whole gradient summed twice;
* ``router_rs`` (moe): the router's copy of the gathered tokens with the
  experts' reduce-scatter backward (``collectives.gather_seq_pair``'s two
  tensors one): the router's whole gradient summed twice.

Last, ``paths/<name>/...``: the layers that run whole on every rank under
sequence parallelism (``PATHS``: attention whose query heads the model axis
does not divide, an MLP whose hidden dim it does not, an MoE whose shared
expert's it does not), in f32, each with the sequence split and without it
on the whole sequence on the same weights: the output, the gradients of a
fixed projection of it to x and every weight (the rank's block of x).
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ssm_world import Patch, _flat  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3
MESH = (2, 2)            # (data, model)
GATES = (0.5, -0.7)      # the vlm's gate_attn, gate_mlp
# case -> (arch, config changes, batch, seq, every leaf and activation in f32)
CASES = {"moe": ("qwen2_moe_a2_7b", {}, 4, 32, False),
         "dense": ("qwen3_1_7b", {}, 4, 32, False),
         "pattern": ("gemma3_1b", {"n_layers": 6}, 4, 32, True),
         "vlm": ("llama_3_2_vision_90b", {"n_layers": 4}, 4, 32, True)}
FAULTS = {"dense": "norm_unsummed", "vlm": "cross_rs", "moe": "router_rs"}
PATHS = ("attention", "mlp", "moe")
PATH_B, PATH_S, PATH_D = 2, 8, 64


def path_case(name: str, tp):
    """(the layer as a function of (x, weights, sp), its weights (this
    rank's slices, f32, drawn from one seed on every rank), names of the
    weights): the layers of ``PATHS`` on the model axis ``tp``."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import moe_layer as M
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(s, generator=g) * s[0] ** -0.5
    d = PATH_D
    if name == "attention":        # 3 query heads over a 2-way axis: wq whole
        dims = L.AttnDims(d, 3, 1, 16)
        w = {"wq": r(d, 48), "wk": r(d, 16), "wv": r(d, 16), "wo": r(48, d)}
        return (lambda x, w, sp: L.self_attn_full(x, w, dims, tp=tp, sp=sp)[0]), w
    if name == "mlp":              # a hidden dim of 33: w1 / w3 / w2 whole
        w = {"w1": r(d, 33), "w3": r(d, 33), "w2": r(33, d)}
        return (lambda x, w, sp: L.swiglu(x, w["w1"], w["w3"], w["w2"], sp=sp)), w
    # a shared expert of 33 hidden units: whole on every rank; the experts sharded
    cfg = dataclasses.replace(reduced(get_config("qwen2_moe_a2_7b")), d_model=d, d_expert=33)
    e = M.n_experts_padded(cfg, tp.size)
    lo = tp.index * e // tp.size
    w = {"router": r(d, e), "w1": r(e, d, 33)[lo:lo + e // tp.size],
         "w3": r(e, d, 33)[lo:lo + e // tp.size], "w2": r(e, 33, d)[lo:lo + e // tp.size],
         "sw1": r(d, 33), "sw3": r(d, 33), "sw2": r(33, d)}
    return (lambda x, w, sp: M.moe_ffn(x, w, cfg, mesh_info=path_case.minfo,
                                       seq=sp is not None)[0]), w


def case_cfg(name: str):
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    arch, changes, *_ = CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def tree(z, prefix: str, f32: bool) -> dict:
    """The npz entries under ``prefix/`` as a nested dict of tensors: bf16
    but the router's f32, or (``f32``) all f32."""
    out = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        path = k[len(prefix) + 1:].split("/")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = torch.from_numpy(np.array(z[k]))
        node[path[-1]] = a if f32 or path[-1] == "router" else a.to(torch.bfloat16)
    return out


def rank_main(rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch import collectives as C
    from repro_torch.launch.mesh import init_rank, make_mesh, mesh_info
    from repro_torch.launch.partition import (batch_specs, data_dims, param_specs, shard_leaf,
                                              zero_specs)
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM
    from repro_torch.models import moe_layer as M
    from repro_torch.models.params import shard_params
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    init_rank("gloo")
    mesh = make_mesh(MESH, ("data", "model"), "gloo", "cpu")
    minfo = mesh_info(mesh)
    faults = {"norm_unsummed": Patch(TM, "_norm_w", lambda w, shard: w),
              "cross_rs": Patch(TM, "_gather_whole", lambda x, shard: C.gather_seq(x, shard.tp)),
              "router_rs": Patch(C, "gather_seq_pair", lambda x, ax: (C.gather_seq(x, ax),) * 2)}
    routes = []
    orig_route = M.route

    def route(*a):
        w, ids, probs = orig_route(*a)
        routes.append(ids.numpy().copy())
        return w, ids, probs

    out = {"coords": np.array([mesh.coords["data"], mesh.coords["model"]])}
    for name, (arch, _, _, S, f32) in CASES.items():
        ref = os.path.join(out_dir, f"inputs_{name}.npz")
        t0 = time.monotonic()
        while not os.path.exists(ref) and time.monotonic() - t0 < 300:
            time.sleep(0.1)
        z = np.load(ref)
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if arch == "gemma3_1b" else "0"
        cfg = case_cfg(name)
        whole = tree(z, f"{name}/params", f32)
        L.PDT = torch.float32 if f32 else torch.bfloat16
        pspecs = param_specs(cfg, whole, n_model=MESH[1])
        zspecs = zero_specs(whole, pspecs, dp="data", n_dp=MESH[0])

        def rows(t):
            return shard_leaf(t, batch_specs({"t": t}, dp="data", n_dp=MESH[0])["t"], mesh)

        batch = {"tokens": rows(torch.from_numpy(z[f"{name}/io/tokens"]).long())}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rows(torch.from_numpy(z[f"{name}/io/front"]).to(L.PDT))
        odd = dict(batch, tokens=batch["tokens"][:, :S - 1])

        fsdp = dict(minfo, fsdp=data_dims(pspecs, zspecs))

        def forward(bundle, tag, b):
            C.reset()
            specs = zspecs if bundle.mesh_info is fsdp else pspecs
            with torch.no_grad():
                logits = bundle.forward(shard_params(whole, specs, mesh), b)[0]
            out[f"{tag}/logits"] = logits.float().numpy()
            for op, r in C.record().items():
                out[f"{tag}/count/{op}"] = r["count"]

        def prefill(bundle, tag):
            with torch.no_grad():
                logits, cache = bundle.prefill(shard_params(whole, pspecs, mesh), batch)
            out[f"{tag}/prefill/logits"] = logits.float().numpy()
            for k, v in cache.items():
                out[f"{tag}/prefill/{k}"] = v.float().numpy()

        def train(bundle, tag):
            params = shard_params(whole, zspecs if bundle.mesh_info is fsdp else pspecs, mesh)
            opt = ZeRO1(AdamW(lr=LR), pspecs, zspecs, bundle.mesh_info)
            params, state, m = make_train_step(bundle, opt)(params, opt.init(params), batch)
            for k, v in m.items():
                out[f"{tag}/metrics0/{k}"] = float(v)
            for j, t in enumerate(tree_leaves(state.m)):
                out[f"{tag}/m0/{j}"] = t.numpy().copy()
            return params

        for flag, tag in (("1", "sp"), ("0", "nosp")):
            os.environ["REPRO_OPT_SEQ_PARALLEL"] = flag
            bundle = TM.build(cfg, mesh_info=minfo)
            M.route = route
            forward(bundle, f"{name}/{tag}", batch)
            M.route = orig_route
            for i, ids in enumerate(routes):
                out[f"{name}/{tag}/route/{i}"] = ids
            routes.clear()
            forward(bundle, f"{name}/{tag}/odd", odd)
            prefill(bundle, f"{name}/{tag}")
            _flat(train(bundle, f"{name}/{tag}"), f"{name}/{tag}/params1", out)
        os.environ["REPRO_OPT_SEQ_PARALLEL"] = "1"
        if cfg.is_moe:
            bundle = TM.build(cfg, mesh_info=fsdp)
            forward(bundle, f"{name}/fsdp", batch)
            train(bundle, f"{name}/fsdp")
        if name in FAULTS:
            with faults[FAULTS[name]]:
                train(TM.build(cfg, mesh_info=minfo), f"{name}/{FAULTS[name]}")
            os.environ["REPRO_OPT_SEQ_PARALLEL"] = "0"
    L.PDT = torch.bfloat16
    tp = mesh.axis("model")
    path_case.minfo = minfo
    g = torch.Generator().manual_seed(8)
    x = torch.randn((PATH_B, PATH_S, PATH_D), generator=g)
    proj = torch.randn((PATH_B, PATH_S, PATH_D), generator=g)
    n = PATH_S // tp.size
    for name in PATHS:
        fn, weights = path_case(name, tp)
        for tag, sp in (("sp", tp), ("whole", None)):
            w = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
            xin = (x[:, tp.index * n:(tp.index + 1) * n] if sp else x).clone().requires_grad_(True)
            y = fn(xin, w, sp)
            (y * (proj[:, tp.index * n:(tp.index + 1) * n] if sp else proj)).sum().backward()
            out[f"paths/{name}/{tag}/y"] = y.detach().numpy()
            out[f"paths/{name}/{tag}/dx"] = xin.grad.numpy()
            for k, v in w.items():
                out[f"paths/{name}/{tag}/d{k}"] = v.grad.numpy()
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def main():
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import spawn
    spawn(rank_main, (sys.argv[1],), 4)


if __name__ == "__main__":
    main()
