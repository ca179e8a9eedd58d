"""The port's FSDP train step in a gloo world of 4 CPU processes, for
tests/test_torch_fsdp.py: the scenarios of tests/torch_fsdp_ref.py on its
params and tokens, each run twice, with the params as ZeRO-1 blocks
(``param_specs``) and as FSDP slices (``zero_specs``,
``mesh_info["fsdp"]``). Imports no JAX.

    python tests/torch_fsdp_world.py DIR

(``DIR/inputs_<scenario>.npz``: what tests/torch_fsdp_ref.py writes first;
each rank waits for a scenario's before running it, so the world may start
beside the reference.)

Each rank writes ``DIR/rank<r>.npz``: its coordinates; ``gather/...``, the
data-axis gather of a bf16 slice (``collectives.gather_params``) forward
and backward beside ``gather_from``'s; then for each scenario and each of
``zero1`` and ``fsdp``: the forward's logits, two AdamW steps of
``MICROBATCHES`` microbatches (each step's metrics, the first moment after
step 1, the params after step 2, the collectives' counts and bytes over
the steps), and the shapes of the params it held. Beside them, the planted
faults that the test requires to fail:

* ``<scenario>_no_sum`` (moe, mamba): the data-axis gather with a backward
  that keeps the rank's slice of its own gradient, not the sum over the
  data axes (``gather_from``'s): one FSDP step's first moment;
* ``mamba_layer_slice``: a leaf whose data-axis dim is the stack's layer
  dim read as if that dim were whole, layer l from the rank's own slice:
  the FSDP forward's logits.

``<scenario>_f32/fsdp/logits`` (``F32_WITNESS``): the FSDP forward of a
bf16 scenario with every leaf and ``PDT`` in f32.
``moe_mb1/...``: one FSDP step of one microbatch, for the gathers' count
(``<tag>/forward_gathers``: the all-gathers of a run's no-grad forward).
``rank_model/<name>/<mode>/...``: ``launch/train.py rank_model`` on the
mesh by the rule (``auto``: its ``fsdp`` and ``state_gb_dev``) and forced
(``on``, ``off``), whether the params it draws equal ``shard_params`` of
the whole seeded tree under ``zero_specs`` (``param_specs`` off), leaf for
leaf: an MoE tree is drawn whole and cut, Mamba2's leaf by leaf, the
pattern stack's as blocks then cut.
Then the families no reference scenario covers, from the port's own seeded
params at reduced widths: ``vlm`` (the cross layers' gates set to
``GATES``), ``encdec`` and ``pattern`` (gemma3 through
``build_dense_pattern``), each as ZeRO-1 and as FSDP: the forward's logits
and one step (metrics, first moment).
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
MESH = (2, 2)
MICROBATCHES = 2
SCENARIOS = {"moe": ("qwen2_moe_a2_7b", {}, False),
             "mamba": ("mamba2_2_7b", {}, False),
             "zamba": ("zamba2_7b", {"n_layers": 3}, True)}
NO_SUM = ("moe", "mamba")
# bf16 scenarios whose FSDP forward also runs in f32, against the
# reference's f32 forward (tests/torch_fsdp_ref.py's ``F32_WITNESS``)
F32_WITNESS = ("mamba",)
F32_LEAVES = ("router", "A_log", "D", "dt_bias")
FAMILIES = {"vlm": ("llama_3_2_vision_90b", {}), "encdec": ("seamless_m4t_medium", {}),
            "pattern": ("gemma3_1b", {})}
FAMILY_SEED = 7
GATES = (0.5, -0.7)
FRONT = {"vlm": "patch_embeds", "encdec": "frames"}


def scenario_cfg(name: str):
    import dataclasses

    from repro_torch.configs.base import get_config, reduced
    arch, changes, *_ = {**SCENARIOS, **FAMILIES}[name]
    return dataclasses.replace(reduced(get_config(arch)), **changes)


def tree(z, prefix: str, f32: bool = False) -> dict:
    """The npz entries under ``prefix/`` as a nested dict of tensors: bf16
    but the f32 leaves of the reference's trees, or (``f32``) all f32."""
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


class GatherKeepsSlice(torch.autograd.Function):
    """The planted fault: the data-axis gather whose backward keeps the
    rank's slice of its own gradient (``gather_from``'s), with no sum."""

    @staticmethod
    def forward(ctx, w, ax, dim):
        from repro_torch import collectives as C
        ctx.ax, ctx.dim, ctx.size = ax, dim, w.shape[dim]
        return C.all_gather(w, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.size, ctx.size).contiguous(), None, None


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
    from repro_torch.models.model import build
    from repro_torch.models.params import shard_params
    from repro_torch.training.optimizer import AdamW, ZeRO1, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    init_rank("gloo")
    mesh = make_mesh(MESH, ("data", "model"), "gloo", "cpu")
    minfo = mesh_info(mesh)
    d = mesh.coords["data"]
    out = {"coords": np.array([d, mesh.coords["model"]])}

    # the data-axis gather on its own: a bf16 slice [3, 4] of a [3, 8] weight
    dp = mesh.axis("data")
    g = torch.Generator().manual_seed(11)
    parts = [torch.randn((3, 4), generator=g).to(torch.bfloat16) for _ in range(MESH[0])]
    ups = [torch.randn((3, 8), generator=g) for _ in range(MESH[0])]
    for tag, gather in (("params", C.gather_params), ("from", C.gather_from)):
        w = parts[d].clone().requires_grad_(True)
        whole = gather(w, dp, 1)
        (whole.float() * ups[d]).sum().backward()
        out[f"gather/{tag}/fwd"] = whole.detach().float().numpy()
        out[f"gather/{tag}/grad"] = w.grad.float().numpy()
        out[f"gather/{tag}/grad_dtype"] = np.array(str(w.grad.dtype))

    def shard_rows(t):
        return shard_leaf(t, batch_specs({"t": t}, dp="data", n_dp=MESH[0])["t"], mesh)

    def run(tag, cfg, whole, batch, kind, steps, microbatches=MICROBATCHES, forward=True):
        """``kind``'s params (ZeRO-1 blocks or FSDP slices) of ``whole``:
        the forward's logits, then ``steps`` steps."""
        pspecs = param_specs(cfg, whole, n_model=MESH[1])
        zspecs = zero_specs(whole, pspecs, dp="data", n_dp=MESH[0])
        info = dict(minfo, fsdp=data_dims(pspecs, zspecs) if kind == "fsdp" else None)
        bundle = build(cfg, mesh_info=info)
        params = shard_params(whole, zspecs if kind == "fsdp" else pspecs, mesh)
        for j, t in enumerate(tree_leaves(params)):
            out[f"{tag}/shape/{j}"] = np.array(t.shape)
        if forward:
            C.reset()
            with torch.no_grad():
                out[f"{tag}/logits"] = bundle.forward(params, batch)[0].float().numpy()
            out[f"{tag}/forward_gathers"] = np.array(C.record().get(
                "all-gather", {"count": 0})["count"])
        opt = ZeRO1(AdamW(lr=LR), pspecs, zspecs, info)
        state = opt.init(params)
        step = make_train_step(bundle, opt, microbatches=microbatches)
        C.reset()
        for i in range(steps):
            params, state, m = step(params, state, batch)
            for k, v in m.items():
                out[f"{tag}/metrics{i}/{k}"] = float(v)
            if i == 0:
                for j, t in enumerate(tree_leaves(state.m)):
                    out[f"{tag}/m0/{j}"] = t.numpy().copy()
        for op, r in C.record().items():
            out[f"{tag}/collectives/{op}"] = np.array([r["count"], r["bytes"]])
        return params

    def layer_slice(self, l):
        """The planted fault: layer l of a layer-dim leaf from the rank's
        own slice, as if the layer dim were whole."""
        if self.dim == 0:
            return self.t[l % self.t.shape[0]]
        return TM._Sliced(self.t[l], self.dim - 1, self.ax)

    for name, (_, _, f32) in SCENARIOS.items():
        ref = os.path.join(out_dir, f"inputs_{name}.npz")
        t0 = time.monotonic()
        while not os.path.exists(ref) and time.monotonic() - t0 < 300:
            time.sleep(0.1)
        z = np.load(ref)
        cfg = scenario_cfg(name)
        whole = tree(z, f"{name}/params", f32)
        L.PDT = torch.float32 if f32 else torch.bfloat16
        batch = {"tokens": shard_rows(torch.from_numpy(z[f"{name}/io/tokens"]).long())}
        for kind in ("zero1", "fsdp"):
            _flat(run(f"{name}/{kind}", cfg, whole, batch, kind, 2), f"{name}/{kind}/params2",
                  out)
        if name in NO_SUM:
            with Patch(C, "gather_params", lambda w, ax, dim: GatherKeepsSlice.apply(
                    w, ax, dim % w.ndim)):
                run(f"{name}_no_sum", cfg, whole, batch, "fsdp", 1, forward=False)
        if name == "mamba":
            with Patch(TM._Sliced, "__getitem__", layer_slice):
                run("mamba_layer_slice", cfg, whole, batch, "fsdp", 0)
        if name in F32_WITNESS:
            L.PDT = torch.float32
            run(f"{name}_f32/fsdp", cfg, tree(z, f"{name}/params", True), batch, "fsdp", 0)
        if name == "moe":
            run("moe_mb1", cfg, whole, batch, "fsdp", 1, microbatches=1)
    L.PDT = torch.bfloat16

    from repro_torch.launch.train import rank_model
    for name in ("moe", "mamba", "pattern"):
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if name == "pattern" else "0"
        cfg = scenario_cfg(name)
        whole = build(cfg, mesh_info=minfo).init(FAMILY_SEED, "cpu")
        pspecs = param_specs(cfg, whole, n_model=MESH[1])
        zspecs = zero_specs(whole, pspecs, dp="data", n_dp=MESH[0])
        for mode, fsdp in (("auto", None), ("on", True), ("off", False)):
            rr = rank_model(cfg, mesh, torch.device("cpu"), None, FAMILY_SEED, LR, fsdp)
            want = shard_params(whole, zspecs if rr.fsdp else pspecs, mesh)
            out[f"rank_model/{name}/{mode}/fsdp"] = np.array(rr.fsdp)
            out[f"rank_model/{name}/{mode}/state_gb_dev"] = np.array(rr.state_gb_dev)
            out[f"rank_model/{name}/{mode}/equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(tree_leaves(rr.params), tree_leaves(want))))
    os.environ["REPRO_OPT_STATIC_WINDOW"] = "0"

    for name, (arch, _) in FAMILIES.items():
        os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if name == "pattern" else "0"
        cfg = scenario_cfg(name)
        bundle = build(cfg)
        whole = bundle.init(FAMILY_SEED, "cpu")
        if name == "vlm":
            whole["blocks"]["cross"]["gate_attn"].fill_(GATES[0])
            whole["blocks"]["cross"]["gate_mlp"].fill_(GATES[1])
        rng = np.random.default_rng(FAMILY_SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))}
        if name in FRONT:
            batch[FRONT[name]] = torch.from_numpy(rng.standard_normal(
                (4, cfg.n_frontend_tokens if name == "vlm" else 32, cfg.frontend_dim))
                .astype(np.float32))
        batch = {k: shard_rows(v) for k, v in batch.items()}
        for kind in ("zero1", "fsdp"):
            run(f"{name}/{kind}", cfg, whole, batch, kind, 1, microbatches=1)
    os.environ["REPRO_OPT_STATIC_WINDOW"] = "0"
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def main():
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import spawn
    spawn(rank_main, (sys.argv[1],), 4)


if __name__ == "__main__":
    main()
