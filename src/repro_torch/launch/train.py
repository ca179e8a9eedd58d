"""Training launcher (port of ``repro.launch.train``): one device, or one
rank of a (data, model) mesh under ``--mesh``.

Builds the bundle, random weights from seed 0, AdamW under the
``cosine_schedule(2e-3, warmup=10, total=steps)`` of
``examples/train_moe.py``, and runs ``make_train_step`` over
``SyntheticLM`` batches, printing each step's loss, gradient norm and
wall time; ``--ckpt`` saves the params (``training/checkpoint.py``).

  python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --layers 4 --steps 10
  python -m repro_torch.launch.train --arch mamba2-2.7b --steps 4
  python -m repro_torch.launch.train --arch zamba2-7b --layers 24 --batch 1 --seq 4096
  python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --reduced --device cpu --steps 4

On the card the model runs at its published widths, ``--layers`` cutting
its depth; the ``reduced()`` configs run on the CPU only (head_dim 32 is
outside the CUDA attention kernels). The batch is tokens only, as the
reference's launcher builds it, so the vlm and enc-dec families, whose
forward also needs ``patch_embeds`` / ``frames``, are refused here: train
them through ``training.train_loop.make_train_step`` with those inputs.

``--mesh DxM`` (or PxDxM, axes pod, data, model) runs the reference's
sharded step: one process a rank, started by ``torchrun`` (its RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or by ``--spawn``
(the ranks on this host, meeting at a file store in a temporary
directory: ``launch/mesh.py spawn``). ``--backend`` is said
outright and printed with the ranks a card holds: ``nccl`` takes one card
a rank and refuses more ranks than cards; ``gloo`` lets ranks share a card
(several ranks on one H100) and runs on the CPU. A rank on the CPU while a
card is present is refused. Each rank draws the whole tree from the seed
and keeps its blocks (``launch/partition.py param_specs``,
``models/params.py shard_params``), its data shard of each batch
(``batch_specs``), and ZeRO-1 moments (``zero_specs``,
``training/optimizer.py ZeRO1``); every family but the vlm and the
enc-dec, whose batches are refused here as they are without a mesh
(``frontend_misfit``), the static-window pattern stack under
``REPRO_OPT_STATIC_WINDOW`` (the spawned ranks inherit it). Rank 0
prints each step; every rank prints one JSON line at the end: its
coordinates, device, peak memory, step ms, the collectives' counts, bytes
and host seconds, its kernels' launches, whether its params are FSDP, the
rule's ``state_gb_dev`` and the bytes it plans for its params, moments
and accumulator under the specs it holds.

``--fsdp {auto,on,off}`` (default ``auto``): FSDP (ZeRO-3) of the params,
the reference dry-run's rule (``launch/partition.py fsdp_rule``): where the
bf16 params plus f32 moments at tensor-parallel sharding alone reckon past
8 GB a device (``state_gb_dev``), each rank stores its params under
``zero_specs`` too, its ``param_specs`` blocks cut again over the data
axes; the forward gathers a layer's slices inside its checkpoint (and the
recompute again), the gradients reach the slices reduce-scattered, and
``ZeRO1`` updates the slices with no all-gather (``models/model.py``).
``on`` and ``off`` force it. Qwen2-MoE-A2.7B at 3 layers on 2 x 2 reckons
10.12 GB and turns it on; at 2 layers, 7.26 GB, off.

``REPRO_OPT_SEQ_PARALLEL=1`` in the environment (which ``--spawn``'s ranks
inherit, as the reference's launchers read it) runs Megatron sequence
parallelism on the mesh (``models/model.py``): the residual stream a block
of the sequence over the model axis, each block's output all-reduces a
reduce-scatter and an all-gather; the same values. Each rank's JSON line
says ``seq_parallel``.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-moe-a2.7b \
      --layers 2 --mesh 2x2 --backend gloo --batch 4 --seq 4096
  python -m repro_torch.launch.train --arch zamba2-7b --layers 7 --mesh 2x2 \
      --backend gloo --spawn --batch 4 --seq 5120
  python -m repro_torch.launch.train --arch mamba2-2.7b --reduced --device cpu \
      --mesh 2x2 --backend gloo --spawn --steps 2
  REPRO_OPT_STATIC_WINDOW=1 python -m repro_torch.launch.train --arch gemma3-1b \
      --reduced --device cpu --mesh 2x2 --backend gloo --spawn --steps 2
  python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --layers 3 --mesh 2x2 \
      --backend gloo --spawn --batch 4 --seq 4096 --fsdp auto
  REPRO_OPT_SEQ_PARALLEL=1 python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --device cpu --mesh 2x2 --backend gloo --spawn --steps 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional, Sequence, Tuple

from repro_torch.launch.serve import resolve_config

# families whose forward needs a frontend's inputs beside the tokens
FRONTEND_FAMILIES = {"vlm": "patch_embeds", "encdec": "frames"}


def frontend_misfit(cfg) -> Optional[str]:
    """Why this launcher cannot train ``cfg`` (with or without a mesh), or
    None: a forward that needs a frontend's inputs beside the tokens."""
    if cfg.family in FRONTEND_FAMILIES:
        return (f"the {cfg.family} family's forward needs '{FRONTEND_FAMILIES[cfg.family]}' "
                "beside the tokens, and this launcher's batches are tokens only; train it "
                "through make_train_step with that input")
    return None


def kernel_misfit(cfg) -> Optional[str]:
    """Why the CUDA kernels cannot run ``cfg``, or None: attention head
    dims outside ``flash_attention``'s, a Mamba (P, N) outside
    ``ssd_scan``'s."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.kernels.ssd_scan import KERNEL_SHAPES
    if cfg.n_heads and cfg.hd not in HEAD_DIMS:
        return f"head_dim {cfg.hd} is outside the attention kernels' {HEAD_DIMS}"
    if cfg.ssm_state and (cfg.ssm_head_dim, cfg.ssm_state) not in KERNEL_SHAPES:
        return (f"(P, N) = ({cfg.ssm_head_dim}, {cfg.ssm_state}) is outside "
                f"ssd_scan's {KERNEL_SHAPES}")
    return None


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="a config id")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized variant (CPU only: head_dim 32)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences per step (default 4 reduced, else 2)")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens per sequence (default 32 reduced, else 2048)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None, help="save the params here (.npz)")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) or PxDxM: run one rank of this mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend under --mesh (no default)")
    ap.add_argument("--spawn", action="store_true",
                    help="start the mesh's ranks on this host")
    ap.add_argument("--fsdp", choices=("auto", "on", "off"), default="auto",
                    help="FSDP of the params under --mesh: by the reference's rule "
                         "(auto), or forced")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh:
        return _mesh_main(ap, args, list(argv) if argv is not None else sys.argv[1:])

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import AdamW, cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    cfg = resolve_config(args.arch, use_reduced=args.reduced, layers=args.layers)
    device = torch.device(args.device)
    if frontend_misfit(cfg):
        ap.error(f"{cfg.name}: {frontend_misfit(cfg)}")
    misfit = kernel_misfit(cfg) if device.type == "cuda" else None
    if misfit:
        ap.error(f"{cfg.name}: {misfit}; run it with --device cpu")
    B = args.batch or (4 if args.reduced else 2)
    S = args.seq or (32 if args.reduced else 2048)
    if B % args.microbatches:
        ap.error(f"--batch {B} does not split into {args.microbatches} microbatches")

    bundle = build(cfg)
    params = bundle.init(args.seed, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params / 1e6:.1f}M "
          f"batch={B} seq={S} microbatches={args.microbatches} device={device}")
    opt = AdamW(lr=cosine_schedule(2e-3, warmup=10, total=args.steps))
    opt_state = opt.init(params)
    step = make_train_step(bundle, opt, microbatches=args.microbatches)
    it = SyntheticLM(cfg.vocab, seed=args.seed).batches(B, S)
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(it)).to(device)}
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"step {i}: loss={loss:.4f} gnorm={gnorm:.2f} "
              f"wall={time.perf_counter() - t0:.3f}s", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, params, extra={"arch": cfg.name, "steps": args.steps})
        print("checkpoint ->", args.ckpt)


# -- the mesh ------------------------------------------------------------------


def parse_mesh(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """"2x2" -> ((2, 2), ("data", "model")); "2x2x2" adds "pod" in front."""
    shape = tuple(int(v) for v in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: give DxM or PxDxM")
    return shape, axes


def rank_device(backend: str, device: str, local_rank: int, local_world: int):
    """(device, ranks a card holds) of a rank, by the rules of the module
    docstring; raises where they refuse."""
    import torch
    if device == "cpu":
        if torch.cuda.is_available():
            raise RuntimeError("a rank on the CPU while a card is present: drop --device cpu")
        if backend != "gloo":
            raise RuntimeError("ranks on the CPU need --backend gloo")
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (--device cpu --backend gloo runs on the CPU)")
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if local_world > cards:
            raise RuntimeError(f"nccl takes one card a rank: {local_world} ranks, {cards} cards "
                               "(--backend gloo shares cards)")
        return torch.device("cuda", local_rank), 1
    per_card = -(-local_world // cards)
    return torch.device("cuda", local_rank // per_card), per_card


@dataclasses.dataclass
class RankRun:
    """One rank's mesh, bundle, param blocks (slices under FSDP), specs,
    ZeRO-1 optimizer and state (``rank_setup``); ``state_gb_dev`` is
    ``fsdp_rule``'s reckoning, ``fsdp`` whether the params are FSDP."""
    cfg: object
    mesh: object
    mesh_info: dict
    bundle: object
    params: dict
    pspecs: dict
    zspecs: dict
    opt: object
    state: object
    device: object
    ranks_per_card: Optional[int]
    fsdp: bool = False
    state_gb_dev: float = 0.0

    def planned_bytes(self) -> dict:
        """Bytes this rank holds by plan (``launch/dryrun.py
        _sharded_bytes``): its params under the specs it stores them by, and
        the f32 moments and f32 gradient accumulator under ``zero_specs``
        (the port's step accumulates the slices at any microbatch count)."""
        from repro_torch.launch.dryrun import _sharded_bytes
        whole = self.bundle.init(0, device="meta")
        return dict(params=_sharded_bytes(whole, self.zspecs if self.fsdp else self.pspecs,
                                          self.mesh),
                    moments=_sharded_bytes(whole, self.zspecs, self.mesh, 8),
                    accumulator=_sharded_bytes(whole, self.zspecs, self.mesh, 4))

    def shard_batch(self, batch: dict) -> dict:
        """The rank's data shard of a whole batch (``batch_specs``)."""
        from repro_torch.launch.partition import batch_specs, shard_leaf
        dp = tuple(self.mesh_info["dp"])
        specs = batch_specs(batch, dp=dp if len(dp) > 1 else dp[0],
                            n_dp=self.mesh.size(dp))
        return {k: shard_leaf(v, specs[k], self.mesh).to(self.device) for k, v in batch.items()}


def rank_setup(cfg, shape, axes, backend: str, device: str, seed: int, lr=None,
               fsdp: Optional[bool] = None) -> RankRun:
    """Initialize this process as a rank (``launch/mesh.py init_rank``),
    build its mesh, then ``rank_model``."""
    import torch

    from repro_torch.launch.mesh import init_rank, make_mesh

    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", math.prod(shape)))
    dev, per_card = rank_device(backend, device, int(os.environ.get("LOCAL_RANK", 0)),
                                local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:   # the host's cores shared among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    init_rank(backend)
    mesh = make_mesh(shape, axes, backend, dev)
    return rank_model(cfg, mesh, dev, per_card, seed, lr, fsdp)


def rank_model(cfg, mesh, dev, per_card, seed: int, lr=None,
               fsdp: Optional[bool] = None) -> RankRun:
    """A rank's bundle on ``mesh``, its blocks of the tree drawn from
    ``seed`` on ``dev`` (``init(blocks=True)``: each leaf cut as it is
    drawn, so the ranks sharing a card never hold the whole tree; an MoE
    tree is drawn whole and cut) and a ZeRO-1 ``AdamW(lr=lr)`` (none, and
    no state, where ``lr`` is None: a serving rank, whose params are never
    FSDP). ``fsdp``: the params FSDP (stored under ``zero_specs``), or not;
    None applies ``partition.fsdp_rule`` to the tree's bytes and the
    mesh's model axis. Under FSDP ``mesh_info["fsdp"]`` is the tree of each
    leaf's data-axis dim (``partition.data_dims``), which the bundle's
    ``init`` and ``forward`` and ``ZeRO1`` read; else None."""
    import torch

    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.launch.partition import data_dims, fsdp_rule, param_specs, zero_specs
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import AdamW, ZeRO1

    minfo = mesh_info(mesh)
    whole = build(cfg, mesh_info=minfo).init(seed, device="meta")
    state_gb_dev, by_rule = fsdp_rule(tree_bytes(whole), mesh.shape["model"])
    fsdp = lr is not None and (by_rule if fsdp is None else fsdp)
    pspecs = param_specs(cfg, whole, n_model=mesh.shape["model"])
    dp = tuple(minfo["dp"])
    zspecs = zero_specs(whole, pspecs, dp=dp if len(dp) > 1 else dp[0], n_dp=mesh.size(dp))
    minfo["fsdp"] = data_dims(pspecs, zspecs) if fsdp else None
    bundle = build(cfg, mesh_info=minfo)
    params = bundle.init(seed, device=dev, blocks=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opt = None if lr is None else ZeRO1(AdamW(lr=lr), pspecs, zspecs, minfo)
    return RankRun(cfg, mesh, minfo, bundle, params, pspecs, zspecs, opt,
                   None if opt is None else opt.init(params), dev, per_card, fsdp,
                   state_gb_dev)


def _spawned_rank(local_rank: int, argv: list, entry=None) -> None:
    """A rank started by ``--spawn`` (``launch/mesh.py spawn``, which sets
    its environment): ``entry(argv)``, a launcher's ``main``, this one's by
    default."""
    (entry or main)(argv)


def _mesh_main(ap, args, argv: list):
    import torch

    try:
        shape, axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if args.backend is None:
        ap.error("--mesh needs --backend nccl or gloo")
    if args.ckpt:
        ap.error("--ckpt under --mesh is not ported: the ranks hold blocks of the params")
    world = math.prod(shape)
    if args.spawn:
        from repro_torch.launch.mesh import spawn
        print(f"spawning {world} ranks, backend={args.backend}", flush=True)
        spawn(_spawned_rank, ([a for a in argv if a != "--spawn"],), world)
        return

    import torch.distributed as dist

    from repro_torch import collectives
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import opt_flags
    from repro_torch.training.optimizer import cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    cfg = resolve_config(args.arch, use_reduced=args.reduced, layers=args.layers)
    if frontend_misfit(cfg):
        ap.error(f"{cfg.name}: {frontend_misfit(cfg)}")
    if args.device != "cpu":
        misfit = kernel_misfit(cfg)
        if misfit:
            ap.error(f"{cfg.name}: {misfit}")
    B = args.batch or (4 if args.reduced else 2)
    S = args.seq or (32 if args.reduced else 2048)
    run = rank_setup(cfg, shape, axes, args.backend, args.device, args.seed,
                     cosine_schedule(2e-3, warmup=10, total=args.steps),
                     fsdp={"auto": None, "on": True, "off": False}[args.fsdp])
    rank = run.mesh.rank
    n_dp = run.mesh.size(tuple(run.mesh_info["dp"]))
    local_b = B // n_dp if B % n_dp == 0 else B
    if local_b % args.microbatches:
        ap.error(f"the data shard's {local_b} sequences do not split into "
                 f"{args.microbatches} microbatches")
    if rank == 0:
        n_params = sum(t.numel() for t in tree_leaves(run.params))
        print(f"mesh={dict(run.mesh.shape)} arch={cfg.name} layers={cfg.n_layers} "
              f"batch={B} seq={S} microbatches={args.microbatches} backend={args.backend} "
              f"ranks_per_card={run.ranks_per_card} device={run.device.type} "
              f"rank0_params={n_params / 1e6:.1f}M fsdp={run.fsdp} "
              f"state_gb_dev={run.state_gb_dev:.2f} "
              f"seq_parallel={opt_flags.seq_parallel()}", flush=True)
    step = make_train_step(run.bundle, run.opt, microbatches=args.microbatches)
    it = SyntheticLM(cfg.vocab, seed=args.seed).batches(B, S)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    collectives.reset()
    kernels = (expert_ffn, flash_attention, ssd_scan)
    for fn in kernels:
        fn.launches = 0
    params, state, step_ms = run.params, run.state, []
    for i in range(args.steps):
        batch = run.shard_batch({"tokens": torch.from_numpy(next(it))})
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            print(f"step {i}: loss={loss:.4f} gnorm={gnorm:.2f} "
                  f"wall={step_ms[-1] / 1e3:.3f}s", flush=True)
    rec = dict(rank=rank, coords=run.mesh.coords, device=str(run.device),
               backend=args.backend, ranks_per_card=run.ranks_per_card, step_ms=step_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
               collectives=collectives.record(),
               launches={fn.__name__: fn.launches for fn in kernels},
               fsdp=run.fsdp, state_gb_dev=run.state_gb_dev,
               seq_parallel=opt_flags.seq_parallel(),
               planned_bytes=run.planned_bytes())
    dist.barrier()
    sys.stdout.write(json.dumps(rec) + "\n")   # one write: the ranks share the stream
    sys.stdout.flush()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
