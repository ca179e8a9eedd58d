"""The port's sharded ssm and hybrid bundles in a gloo world of 4 CPU
processes, for tests/test_torch_mesh_ssm.py: the scenarios of
tests/torch_mesh_ssm_ref.py on its params and inputs. Imports no JAX.

    python tests/torch_mesh_ssm_world.py DIR

(``DIR/inputs_<scenario>.npz``: the params and inputs
tests/torch_mesh_ssm_ref.py writes first; each rank waits for a
scenario's before running it, so the world may start beside the
reference.)

Each rank writes ``DIR/rank<r>.npz``, for each scenario: its
coordinates, the forward's logits (its data shard, its vocabulary block),
the shapes of ``init_cache``'s leaves and of the decode cache's, two ZeRO-1
AdamW steps (each step's metrics, the first moment after step 1 and the
params after step 2, its blocks), the prefill's logits and ``STEPS``
greedy decode steps (each step's logits gathered whole, its tokens). An
f32 scenario runs with the activation type ``models/layers.py PDT`` set
to f32 on its f32 params.
Beside the sound run three planted faults, which the test requires to
fail their checks:

* ``norm_local``: the gated RMSNorm over the rank's own channels (its mean
  of squares, no all-reduce): the forward's logits;
* ``bc_partial``: B and C entering the heads' region without ``copy_to``,
  so the replicated ``wB`` / ``wC`` / ``conv_B`` / ``conv_C`` keep each
  rank's part of their gradient: one step's first moment;
* ``no_gather``: the decode's conv state stepped on the rank's block of
  B / C channels and that block put in every rank's place instead of the
  gathered whole: the decode's logits fed the sound run's tokens.
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3
STEPS = 6
# scenario -> (arch, config changes, mesh (data, model), batch, train seq, prompt,
# every leaf and activation in f32)
SCENARIOS = {"mamba_2x2": ("mamba2_2_7b", {}, (2, 2), 4, 32, 8, False),
             "mamba_g2_1x4": ("mamba2_2_7b", {"ssm_groups": 2}, (1, 4), 2, 32, 8, False),
             "zamba_2x2": ("zamba2_7b", {"n_layers": 3}, (2, 2), 4, 32, 70, True)}
FAULTED = ("mamba_2x2", "zamba_2x2")
F32_LEAVES = ("A_log", "D", "dt_bias")


def scenario_cfg(name: str):
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    arch, changes, *_ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def tree(z, prefix: str, f32: bool = False) -> dict:
    """The npz entries under ``prefix/`` as a nested dict of tensors: bf16
    but the ssm layer's f32 leaves, or (``f32``) all f32."""
    out = {}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        path = k[len(prefix) + 1:].split("/")
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = torch.from_numpy(np.array(z[k]))
        node[path[-1]] = a if f32 or path[-1] in F32_LEAVES or a.dtype != torch.float32 \
            else a.to(torch.bfloat16)
    return out


def _flat(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = v.detach().float().numpy()


class Patch:
    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.old = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.old)


def rank_main(rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_rank, make_mesh, mesh_info
    from repro_torch.launch.partition import batch_specs, param_specs, shard_leaf, zero_specs
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.models.params import shard_params
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    init_rank("gloo")
    out = {}
    faults = {"norm_local": Patch(S, "_norm", lambda y, w, eps, tp, width: L.rms_norm(y, w, eps)),
              "bc_partial": Patch(S, "_enter_bc", lambda t, tp: t),
              "no_gather": Patch(S, "_gather_bc",
                                 lambda b, c, tp: (b.repeat(1, tp.size), c.repeat(1, tp.size)))}

    for name, (_, _, shape, B, _, prompt_len, f32) in SCENARIOS.items():
        ref = os.path.join(out_dir, f"inputs_{name}.npz")
        t0 = time.monotonic()
        while not os.path.exists(ref) and time.monotonic() - t0 < 300:
            time.sleep(0.1)
        z = np.load(ref)
        cfg = scenario_cfg(name)
        mesh = make_mesh(shape, ("data", "model"), "gloo", "cpu")
        minfo = mesh_info(mesh)
        bundle = build(cfg, mesh_info=minfo)
        whole = tree(z, f"{name}/params", f32)
        L.PDT = torch.float32 if f32 else torch.bfloat16
        pspecs = param_specs(cfg, whole, n_model=shape[1])
        zspecs = zero_specs(whole, pspecs, dp="data", n_dp=shape[0])

        def shard_rows(t):
            return shard_leaf(t, batch_specs({"t": t}, dp="data", n_dp=shape[0])["t"], mesh)

        tokens = shard_rows(torch.from_numpy(z[f"{name}/io/tokens"]).long())
        prompt = shard_rows(torch.from_numpy(z[f"{name}/io/prompt"]).long())
        out[f"{name}/coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
        W = min(prompt_len, cfg.sliding_window or prompt_len)
        for key, t in bundle.init_cache(B, W, device="cpu").items():
            out[f"{name}/init_shape/{key}"] = np.array(t.shape)

        def forward(tag):
            with torch.no_grad():
                logits = bundle.forward(shard_params(whole, pspecs, mesh), {"tokens": tokens})[0]
            out[f"{tag}/logits"] = logits.float().numpy()

        def train(tag, steps):
            params = shard_params(whole, pspecs, mesh)
            opt = ZeRO1(AdamW(lr=LR), pspecs, zspecs, minfo)
            state = opt.init(params)
            step = make_train_step(bundle, opt)
            for i in range(steps):
                params, state, m = step(params, state, {"tokens": tokens})
                for k, v in m.items():
                    out[f"{tag}/metrics{i}/{k}"] = float(v)
                if i == 0:
                    for j, t in enumerate(tree_leaves(state.m)):
                        out[f"{tag}/m0/{j}"] = t.numpy().copy()
            return params

        def decode(tag, fed=None):
            """Prefill, ``decode_cache`` and STEPS greedy steps (or steps
            fed ``fed``'s tokens)."""
            params = shard_params(whole, pspecs, mesh)
            with torch.no_grad():
                logits, cache = bundle.prefill(params, {"tokens": prompt})
                out[f"{tag}/logits_prefill"] = logits.float().numpy()
                cache = decode_cache(bundle, cache, W)
                for key, t in cache.items():
                    out[f"{tag}/shape/{key}"] = np.array(t.shape)
                toks = []
                for t in range(STEPS):
                    tok = greedy_token(logits, cfg.vocab) if fed is None \
                        else torch.from_numpy(fed[t])[:, None].to(torch.int32)
                    toks.append(tok[:, 0].numpy().copy())
                    logits, cache = bundle.decode_step(params, {"token": tok}, cache)
                    out[f"{tag}/logits/{t}"] = logits.float().numpy()
            out[f"{tag}/tokens"] = np.stack(toks)

        forward(name)
        _flat(train(name, 2), f"{name}/params2", out)
        decode(name)
        if name in FAULTED:
            with faults["norm_local"]:
                forward(f"{name}_norm_local")
            with faults["bc_partial"]:
                train(f"{name}_bc_partial", 1)
            with faults["no_gather"]:
                decode(f"{name}_no_gather", fed=out[f"{name}/tokens"])
    L.PDT = torch.bfloat16
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def main():
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import spawn
    spawn(rank_main, (sys.argv[1],), 4)


if __name__ == "__main__":
    main()
