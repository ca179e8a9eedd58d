"""The port's sharded vlm, enc-dec and static-window pattern bundles in a
gloo world of 4 CPU processes, for tests/test_torch_mesh_families.py: the
scenarios of tests/torch_mesh_families_ref.py on its params and inputs,
then the cross attention's layers alone in its three memory layouts.
Imports no JAX.

    python tests/torch_mesh_families_world.py DIR

(``DIR/inputs_<scenario>.npz``: the params and inputs
tests/torch_mesh_families_ref.py writes first; each rank waits for a
scenario's before running it, so the world may start beside the
reference.)

Each rank writes ``DIR/rank<r>.npz``, for each scenario: its coordinates,
the forward's logits (its data shard, its vocabulary block), the shapes of
``init_cache``'s leaves and of the decode cache's, two ZeRO-1 AdamW steps
(each step's metrics, the first moment after step 1 and the params after
step 2, its blocks), the prefill's logits and ``STEPS`` greedy decode steps
(each step's logits gathered whole, its tokens). An f32 scenario runs
with the activation type ``models/layers.py PDT`` set to f32 on its f32
params. Beside the sound run, the planted faults that the test requires to
fail their checks, and a control:

* ``no_lse`` (vlm): the memory's patch blocks not merged (``lse_combine``
  replaced by the rank's own partial): the decode's logits fed the sound
  run's tokens;
* ``no_cross`` (vlm, the control): the cross layers' attention dropped
  (``cross_attn_full`` gives zeros): the forward's logits;
* ``gather_sum`` (enc-dec): the frontend projection's gather with a
  backward that sums the gradient over the model axis before taking the
  rank's slice (the whole gradient, as ``torch.distributed.nn``'s
  all-gather passes it back): one step's first moment of ``proj``;
* ``no_window`` (pattern): the local layers' window left out on the
  slot-sharded decode (``flash_decode`` with ``return_lse`` given no
  window): the decode's logits fed the sound run's tokens.

Then ``cross/<layout>/...``: ``cross_kv``, ``cross_attn_full`` (its output
and the gradients of a fixed projection of it: x, the memory and every
weight, the rank's blocks) and ``cross_attn_decode`` on a rank's slices, in
f32, for the layouts ``CROSS_LAYOUTS`` (heads, patch slots, replicated).
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ssm_world import Patch, _flat, tree  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3
STEPS = 6
GATES = (0.5, -0.7)      # the vlm's gate_attn, gate_mlp
# scenario -> (arch, config changes, mesh (data, model), batch, train seq, prompt,
# every leaf and activation in f32)
SCENARIOS = {"vlm_kv1_2x2": ("llama_3_2_vision_90b", {"n_kv_heads": 1}, (2, 2), 4, 32, 8, False),
             "encdec_2x2": ("seamless_m4t_medium", {}, (2, 2), 4, 32, 12, True),
             "pattern_2x2": ("gemma3_1b", {"n_layers": 7}, (2, 2), 4, 32, 200, True)}
# the frontend's input of a family
FRONT = {"vlm": "patch_embeds", "encdec": "frames"}
# layout -> (query heads, KV heads, memory slots), over a 2-way model axis
CROSS_LAYOUTS = {"heads": (4, 2, 10), "slots": (4, 1, 16), "replicated": (4, 1, 15)}
CROSS_D, CROSS_HD, CROSS_B, CROSS_S = 64, 16, 2, 5


def capacity(name: str) -> int:
    """The decode's ring slots: the prompt and the steps, or a 256-slot
    ring for the pattern stack (its prompt's local windows in model rank
    1's block)."""
    return 256 if name == "pattern_2x2" else SCENARIOS[name][5] + STEPS


def scenario_cfg(name: str):
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    arch, changes, *_ = SCENARIOS[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def cross_inputs(layout: str, seed: int = 0) -> dict:
    """The whole params and inputs of a layout's cross layer test, f32:
    wq, wk, wv, wo, q_norm, k_norm; x [B,S,d], mem [B,M,d], the fixed
    projection g of the output, x1 [B,1,d] for the decode."""
    H, Hkv, M = CROSS_LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    d, hd = CROSS_D, CROSS_HD
    return {"wq": r(d, H * hd) * d ** -0.5, "wk": r(d, Hkv * hd) * d ** -0.5,
            "wv": r(d, Hkv * hd) * d ** -0.5, "wo": r(H * hd, d) * (H * hd) ** -0.5,
            "q_norm": r(hd) * 0.1, "k_norm": r(hd) * 0.1,
            "x": r(CROSS_B, CROSS_S, d), "mem": r(CROSS_B, M, d),
            "g": r(CROSS_B, CROSS_S, d), "x1": r(CROSS_B, 1, d)}


def cross_dims(layout: str):
    from repro_torch.models.layers import AttnDims
    H, Hkv, _ = CROSS_LAYOUTS[layout]
    return AttnDims(CROSS_D, H, Hkv, CROSS_HD, qk_norm=True)


WEIGHTS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")


def cross_run(layout: str, p: dict, inp: dict, tp=None) -> dict:
    """The cross layer on params ``p`` (a rank's slices under ``tp``):
    the full attention's output and the gradients of (out * g).sum() to x,
    mem and the weights; the decode's output over the memory in
    ``cache_specs``' layout (the rank's block of slots where they are
    sharded)."""
    from repro_torch.models import layers as L
    dims = cross_dims(layout)
    leaves = {k: p[k].clone().requires_grad_(True) for k in WEIGHTS}
    x = inp["x"].clone().requires_grad_(True)
    mem = inp["mem"].clone().requires_grad_(True)
    mk, mv = L.cross_kv(mem, leaves, dims, tp)
    out = L.cross_attn_full(x, leaves, dims, mk, mv, tp=tp)
    (out * inp["g"]).sum().backward()
    res = {"out": out.detach(), "dx": x.grad, "dmem": mem.grad}
    res.update({f"d{k}": leaves[k].grad for k in WEIGHTS})
    with torch.no_grad():
        mk, mv = L.cross_kv(inp["mem"], p, dims, tp)
        M = mk.shape[1]
        slots = None
        if tp is not None and mk.shape[2] == dims.n_kv_heads and M % tp.size == 0:
            n = M // tp.size
            mk, mv = (t[:, tp.index * n:(tp.index + 1) * n] for t in (mk, mv))
            slots = M
        res["dec"] = L.cross_attn_decode(inp["x1"], p, dims, mk, mv, tp=tp, mem_slots=slots)
    return res


def cross_specs(layout: str, n_model: int) -> dict:
    """The weights' specs (``launch/partition.py``'s rules) at this model
    axis: dims addressed from the end, ``None`` or ``"model"``."""
    H, Hkv, _ = CROSS_LAYOUTS[layout]
    q, kv = H % n_model == 0, Hkv % n_model == 0
    return {"wq": (None, "model") if q else (), "wk": (None, "model") if kv else (),
            "wv": (None, "model") if kv else (), "wo": ("model", None) if q else (),
            "q_norm": (), "k_norm": ()}


class _GatherSum(torch.autograd.Function):
    """The planted ``gather_sum`` fault: an all-gather whose backward sums
    the gradient over the axis, then keeps the rank's slice."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        from repro_torch import collectives as C
        ctx.ax, ctx.dim, ctx.size = ax, dim, x.shape[dim]
        return C.all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch import collectives as C
        return C.psum(g, ctx.ax).narrow(ctx.dim, ctx.ax.index * ctx.size, ctx.size), None, None


def rank_main(rank: int, out_dir: str, port: int) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="4",
                      LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch import collectives as C
    from repro_torch.launch.mesh import init_rank, make_mesh, mesh_info
    from repro_torch.launch.partition import batch_specs, param_specs, shard_leaf, zero_specs
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, decode_cache, greedy_token
    from repro_torch.models.params import shard_params
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    init_rank("gloo")
    out = {}
    decode_plain = L.flash_decode
    faults = {"no_lse": Patch(C, "lse_combine", lambda o, lse, ax: o),
              "no_cross": Patch(L, "cross_attn_full",
                                lambda x, *a, **k: torch.zeros_like(x)),
              "gather_sum": Patch(C, "gather_from", lambda x, ax, dim: _GatherSum.apply(
                  x, ax, dim % x.ndim)),
              "no_window": Patch(L, "flash_decode", lambda *a, window=-1, return_lse=False:
                                 decode_plain(*a, return_lse=True) if return_lse
                                 else decode_plain(*a, window=window))}
    planted = {"vlm_kv1_2x2": ("no_lse", "no_cross"), "encdec_2x2": ("gather_sum",),
               "pattern_2x2": ("no_window",)}

    for name, (arch, _, shape, B, _, prompt_len, f32) in SCENARIOS.items():
        ref = os.path.join(out_dir, f"inputs_{name}.npz")
        t0 = time.monotonic()
        while not os.path.exists(ref) and time.monotonic() - t0 < 300:
            time.sleep(0.1)
        z = np.load(ref)
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if arch == "gemma3_1b" else "0"
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

        def batch_of(tokens_key, front_key):
            b = {"tokens": shard_rows(torch.from_numpy(z[f"{name}/io/{tokens_key}"]).long())}
            if cfg.family in FRONT:
                b[FRONT[cfg.family]] = shard_rows(torch.from_numpy(
                    z[f"{name}/io/{front_key}"]).to(L.PDT))
            return b

        batch, prompt = batch_of("tokens", "front"), batch_of("prompt", "front_prompt")
        out[f"{name}/coords"] = np.array([mesh.coords["data"], mesh.coords["model"]])
        W = capacity(name)
        extras = {"mem_len": prompt_len} if cfg.family == "encdec" else None
        for key, t in bundle.init_cache(B, W, extras, device="cpu").items():
            out[f"{name}/init_shape/{key}"] = np.array(t.shape)

        def forward(tag):
            with torch.no_grad():
                logits = bundle.forward(shard_params(whole, pspecs, mesh), batch)[0]
            out[f"{tag}/logits"] = logits.float().numpy()

        def train(tag, steps):
            params = shard_params(whole, pspecs, mesh)
            opt = ZeRO1(AdamW(lr=LR), pspecs, zspecs, minfo)
            state = opt.init(params)
            step = make_train_step(bundle, opt)
            for i in range(steps):
                params, state, m = step(params, state, batch)
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
                logits, cache = bundle.prefill(params, prompt)
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
        for fault in planted[name]:
            with faults[fault]:
                if fault == "no_cross":
                    forward(f"{name}_{fault}")
                elif fault == "gather_sum":
                    train(f"{name}_{fault}", 1)
                else:
                    decode(f"{name}_{fault}", fed=out[f"{name}/tokens"])
    L.PDT = torch.bfloat16

    mesh = make_mesh((2, 2), ("data", "model"), "gloo", "cpu")
    tp = mesh.axis("model")
    for layout in CROSS_LAYOUTS:
        inp = cross_inputs(layout)
        specs = cross_specs(layout, tp.size)
        p = {k: shard_leaf(inp[k], specs[k], mesh) for k in WEIGHTS}
        for k, v in cross_run(layout, p, inp, tp).items():
            out[f"cross/{layout}/{k}"] = v.numpy()
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def main():
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(rank_main, args=(sys.argv[1], port), nprocs=4,
                       start_method="spawn")


if __name__ == "__main__":
    main()
