"""The port's sharded prefill and decode in a gloo world of 4 CPU
processes, for tests/test_torch_mesh_decode.py: the scenarios of
tests/torch_mesh_decode_ref.py on its params and prompts. Imports no JAX.

    python tests/torch_mesh_decode_world.py INPUTS.npz OUT_DIR

(INPUTS.npz: the params and prompts tests/torch_mesh_decode_ref.py writes
first; each rank waits for it after joining the process group, so the
world may start beside the reference.)

Each rank writes ``OUT_DIR/rank<r>.npz``, for each scenario: its
coordinates, its data shard's prefill logits, the shapes of its decode
cache and of ``init_cache``'s (``shape/<leaf>``, ``init_shape/<leaf>``),
each greedy step's logits (gathered whole, ``logits/<t>``) and tokens
(``tokens`` [steps, B_loc]) and its router calls' ids in call order. Beside
the sound run of a slot-sharded scenario two planted faults, each fed the
sound run's tokens, whose logits the test requires to part from the
reference's:

* ``avg``: the ranks' partials averaged without their log-sum-exp weights
  (``collectives.lse_combine`` replaced; slot-sharded scenarios only);
* ``wrong_rank``: the new K/V written by the next model rank, into the
  block that does not hold its slot (``layers.write_slot`` shifted by one
  block).
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PROMPT, STEPS = 6, 14
SCENARIOS = {"qwen_2x2": ("qwen2_moe_a2_7b", (2, 2), 4, 16),    # (arch, mesh, B, capacity)
             "granite_2x2": ("granite_34b", (2, 2), 4, 16),
             "granite_1x4": ("granite_34b", (1, 4), 2, 16),
             "granite_2x2_w15": ("granite_34b", (2, 2), 4, 15)}


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


class Patch:
    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.old = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.old)


def rank_main(rank: int, ref: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch import collectives as C
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import init_rank, make_mesh, mesh_info
    from repro_torch.launch.partition import batch_specs, param_specs, shard_leaf
    from repro_torch.models import layers as L
    from repro_torch.models import moe_layer as M
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.models.params import shard_params

    init_rank("gloo")
    t0 = time.monotonic()
    while not os.path.exists(ref) and time.monotonic() - t0 < 300:
        time.sleep(0.1)
    z = np.load(ref)
    out = {}
    routes = []
    orig_route = M.route

    def route(*a):
        w, ids, probs = orig_route(*a)
        routes.append(ids.numpy().copy())
        return w, ids, probs

    M.route = route

    def averaged(o, lse, ax):
        if ax is None or ax.size == 1:
            return o
        return (C.all_gather(o.float()[None], ax, 0).mean(0)).to(o.dtype)

    def shifted_write(n_blocks):
        write = L.write_slot

        def wrong(cache, new, slot, lo=None):
            if lo is None:
                return write(cache, new, slot, lo)
            W = cache.shape[1]
            return write(cache, new, slot, (lo + W) % (W * n_blocks))
        return wrong

    for name, (arch, shape, B, capacity) in SCENARIOS.items():
        cfg = reduced(get_config(arch))
        mesh = make_mesh(shape, ("data", "model"), "gloo", "cpu")
        bundle = build(cfg, mesh_info=mesh_info(mesh))
        whole = _tree(z, f"{name}/params")
        params = shard_params(whole, param_specs(cfg, whole, n_model=shape[1]), mesh)
        prompt = torch.from_numpy(z[f"{name}/io/prompt"]).long()
        prompt = shard_leaf(prompt, batch_specs({"t": prompt}, dp="data", n_dp=shape[0])["t"],
                            mesh)
        out[f"{name}/coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
        for key, t in bundle.init_cache(B, capacity, device="cpu").items():
            out[f"{name}/init_shape/{key}"] = np.array(t.shape)

        def decode(cache, logits, fed=None):
            """STEPS greedy steps (or fed ``fed``'s tokens): (logits, tokens)."""
            steps, toks = [], []
            for t in range(STEPS):
                tok = greedy_token(logits, cfg.vocab) if fed is None \
                    else torch.from_numpy(fed[t])[:, None].to(torch.int32)
                toks.append(tok[:, 0].numpy().copy())
                logits, cache = bundle.decode_step(params, {"token": tok}, cache)
                steps.append(logits.float().numpy())
            return steps, np.stack(toks)

        with torch.no_grad():
            logits, cache = bundle.prefill(params, {"tokens": prompt})
            out[f"{name}/logits_prefill"] = logits.float().numpy()
            cache = decode_cache(bundle, cache, capacity)
            for key, t in cache.items():
                out[f"{name}/shape/{key}"] = np.array(t.shape)
            steps, toks = decode(dict(cache), logits)
            for i, ids in enumerate(routes):
                out[f"{name}/route/{i}"] = ids
            routes.clear()
            out[f"{name}/tokens"] = toks
            for t, lg in enumerate(steps):
                out[f"{name}/logits/{t}"] = lg
            faults = {}
            if cache["k"].shape[2] < capacity:     # the slots are sharded
                faults = {"avg": Patch(C, "lse_combine", averaged),
                          "wrong_rank": Patch(L, "write_slot", shifted_write(shape[1]))}
            for fault, patch in faults.items():
                with patch:
                    steps, _ = decode(dict(cache), logits, fed=toks)
                routes.clear()
                for t, lg in enumerate(steps):
                    out[f"{name}_{fault}/logits/{t}"] = lg
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
