"""Serving launcher (port of ``repro.launch.serve``): the DuoServe-MoE
runtime (host expert store, device expert cache, dual-phase scheduling)
over a stream of SQuAD-like prompts.

ODF traces over 8 prompts, the ExpertMLP trained on them (``mif`` needs
the trace statistics, ``duo`` / ``duo+`` the predictor too), then
``MoEServingEngine.serve`` request by request and the QoS summary.

  python -m repro_torch.launch.serve --arch deepseekmoe-16b
  python -m repro_torch.launch.serve --arch qwen3-30b-a3b --layers 8 --policy lfp
  python -m repro_torch.launch.serve --arch mixtral-8x7b --reduced --device cpu

On the card the model runs at its published widths, ``--layers`` cutting
its depth (each layer's routed experts are pinned in host memory); the
``reduced()`` configs run on the CPU only, since their head_dim of 32 is
outside the CUDA attention kernels.

``--mesh DxM`` is the reference's full mode: the sharded prefill and
decode steps of any family's bundle on a (data, model) mesh (the
static-window pattern stack under ``REPRO_OPT_STATIC_WINDOW``, which the
spawned ranks inherit), one process a rank, started by ``torchrun`` or by
``--spawn`` (``launch/train.py``'s rules for ``--backend``, devices and
ranks a card). The ``--requests`` prompts, each cut to ``PROMPT_LEN``
tokens, are one batch sharded over the data axis, with the vlm's
``patch_embeds`` or the enc-dec's ``frames`` (``PROMPT_LEN`` of them) drawn
from seed 0 (``launch/input_specs.py frontend_inputs``) and sharded with
it; each rank keeps its param blocks (seed 0), prefills its shard, takes
the cache to the decode layout at ``PROMPT_LEN + max-new`` slots, the
hybrid's ring at most its window (``models/model.py decode_cache``: KV
heads or else slots over the model axis, the cross attention's memory
likewise, the ssm states' heads and channels, ``launch/partition.py
cache_specs``) and decodes greedily. Rank 0 prints each request's tokens
with the batch's TTFT and E2E walls; every rank prints one JSON line:
coordinates, device, walls, peak memory, the collectives' counts and
bytes, its kernels' launches and ``seq_parallel``: ``REPRO_OPT_SEQ_PARALLEL``
as the rank read it (the spawned ranks inherit it; ``build_dense``'s, the
pattern stack's and the vlm's self layers' prefill then runs
sequence-parallel, ``models/model.py``; decode has one position and runs
without it).

  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --layers 2 --mesh 2x2 \
      --backend gloo --spawn
  python -m repro_torch.launch.serve --arch mamba2-2.7b --layers 2 --mesh 2x2 \
      --backend gloo --spawn
  python -m repro_torch.launch.serve --arch granite-34b --reduced --device cpu \
      --mesh 2x2 --backend gloo --spawn
  python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --reduced \
      --device cpu --mesh 2x2 --backend gloo --spawn
  REPRO_OPT_STATIC_WINDOW=1 python -m repro_torch.launch.serve --arch gemma3-1b \
      --layers 7 --mesh 2x2 --backend gloo --spawn
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Optional, Sequence

from repro_torch.configs.base import get_config, reduced
from repro_torch.configs.paper_models import PAPER_MODELS

POLICIES = ("odf", "lfp", "mif", "duo", "duo+")
PROMPT_LEN = 32   # tokens of each served prompt (the shortest SQuAD-like prompt's)
# head dims the CUDA attention kernels are built for
# (kernels/flash_attention.py, kernels/flash_decode.py)
KERNEL_HEAD_DIMS = (64, 128)


def resolve_config(arch: str, *, use_reduced: bool = False,
                   layers: Optional[int] = None):
    """The config ``--arch`` names: a ``PAPER_MODELS`` key or any id
    ``get_config`` resolves, optionally ``reduced()``, depth cut to
    ``layers``."""
    cfg = PAPER_MODELS[arch] if arch in PAPER_MODELS else get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if layers is not None:
        if not 1 <= layers <= cfg.n_layers:
            raise ValueError(f"--layers {layers}: {cfg.name} has {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b",
                    help=f"a config id or one of {sorted(PAPER_MODELS)}")
    ap.add_argument("--policy", default="duo", choices=POLICIES)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized variant (CPU only: head_dim 32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model): serve as one rank of this mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend under --mesh (no default)")
    ap.add_argument("--spawn", action="store_true",
                    help="start the mesh's ranks on this host")
    args = ap.parse_args(argv)
    if args.mesh:
        return _mesh_main(ap, args, list(argv) if argv is not None else sys.argv[1:])

    import torch

    from repro_torch.core.predictor import train_predictor
    from repro_torch.core.qos import summarize
    from repro_torch.core.state import StateConstructor
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import MoEServingEngine, collect_traces

    device = torch.device(args.device)
    cfg = resolve_config(args.arch, use_reduced=args.reduced, layers=args.layers)
    if device.type == "cuda" and cfg.hd not in KERNEL_HEAD_DIMS:
        ap.error(f"{cfg.name} has head_dim {cfg.hd}; the CUDA attention kernels "
                 f"take head_dim {' or '.join(map(str, KERNEL_HEAD_DIMS))}: on the "
                 f"card serve the published widths and cut depth with --layers")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu (with --reduced)")
    params = init_params(cfg, seed=0, device=device)
    wl = PromptWorkload(squad_like(cfg.vocab), seed=11)

    stats = predictor = None
    if args.policy in ("mif", "duo", "duo+"):
        tracer, _ = collect_traces(
            cfg, params, [p[:32] for p, _ in wl.prompts(8)], max_new=6)
        stats = tracer.stats()
        if args.policy != "mif":
            sc = StateConstructor(stats)
            X, Y = sc.build_dataset(tracer.as_array())
            predictor, _ = train_predictor(1, X, Y, cfg.top_k, width_scale=0.1,
                                           epochs=5, batch=32, device=device)

    eng = MoEServingEngine(cfg, params, policy=args.policy, stats=stats,
                           predictor=predictor)
    ttfts, e2es, toks = [], [], 0
    for i, (p, _) in enumerate(wl.prompts(args.requests)):
        r = eng.serve(p[:PROMPT_LEN], max_new=args.max_new)
        ttfts.append(r.ttft_wall)
        e2es.append(r.e2e_wall)
        toks += len(r.tokens)
        print(f"req {i}: tokens={r.tokens.tolist()} "
              f"hits={r.hits} misses={r.misses}")
    q = summarize(ttfts, e2es, toks)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"\n{cfg.name} layers={cfg.n_layers} on {where}: policy={args.policy} "
          f"mean_ttft={q.mean_ttft:.2f}s mean_e2e={q.mean_e2e:.2f}s "
          f"p95={q.p95_e2e:.2f}s tok/s={q.tokens_per_s:.2f}")
    return q


def _mesh_main(ap, args, argv: list):
    """``--mesh``: spawn the ranks, or serve as one (module docstring)."""
    import numpy as np
    import torch

    from repro_torch.launch.train import _spawned_rank, kernel_misfit, parse_mesh
    try:
        shape, axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if args.backend is None:
        ap.error("--mesh needs --backend nccl or gloo")
    cfg = resolve_config(args.arch, use_reduced=args.reduced, layers=args.layers)
    if args.device != "cpu":
        misfit = kernel_misfit(cfg)
        if misfit:
            ap.error(f"{cfg.name}: {misfit}")
    world = math.prod(shape)
    if args.spawn:
        from repro_torch.launch.mesh import spawn
        print(f"spawning {world} ranks, backend={args.backend}", flush=True)
        spawn(_spawned_rank, ([a for a in argv if a != "--spawn"], main), world)
        return None

    import torch.distributed as dist

    from repro_torch import collectives
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_cross
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.input_specs import frontend_inputs, generator
    from repro_torch.launch.train import rank_setup
    from repro_torch.models import opt_flags
    from repro_torch.models.model import decode_cache, greedy_token

    run = rank_setup(cfg, shape, axes, args.backend, args.device, seed=0)
    cuda = run.device.type == "cuda"
    S, n_new = PROMPT_LEN, args.max_new
    wl = PromptWorkload(squad_like(cfg.vocab), seed=11)
    prompts = np.stack([p[:S] for p, _ in wl.prompts(args.requests)])
    batch = run.shard_batch({"tokens": torch.from_numpy(prompts),
                             **frontend_inputs(cfg, args.requests, S, generator(0, "cpu"), "cpu")})
    kernels = (expert_ffn, flash_attention, flash_attention_cross, flash_decode, ssd_scan)
    for fn in kernels:
        fn.launches = 0
    collectives.reset()
    capacity = S + n_new
    if cfg.family == "hybrid" and cfg.sliding_window:
        capacity = min(capacity, cfg.sliding_window)     # its ring holds the window
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = run.bundle.prefill(run.params, batch)
        cache = decode_cache(run.bundle, cache, capacity)
        tok = greedy_token(logits, cfg.vocab)
        sync()
        ttft = time.perf_counter() - t0
        out = [tok]
        for _ in range(n_new - 1):
            logits, cache = run.bundle.decode_step(run.params, {"token": tok}, cache)
            tok = greedy_token(logits, cfg.vocab)
            out.append(tok)
        sync()
    e2e = time.perf_counter() - t0
    tokens = torch.cat(out, 1)
    dp = tuple(run.mesh_info["dp"])
    if tokens.shape[0] < args.requests:          # the batch is sharded over the data axes
        tokens = collectives.all_gather(tokens, run.mesh.axis(dp), 0)
    rank = run.mesh.rank
    if rank == 0:
        where = torch.cuda.get_device_name(run.device) if cuda else "cpu"
        print(f"mesh={dict(run.mesh.shape)} arch={cfg.name} layers={cfg.n_layers} "
              f"requests={args.requests} prompt_len={S} max_new={n_new} "
              f"backend={args.backend} ranks_per_card={run.ranks_per_card} on {where}",
              flush=True)
        for i, row in enumerate(tokens.cpu().tolist()):
            print(f"req {i}: tokens={row} ttft={ttft:.3f}s e2e={e2e:.3f}s", flush=True)
    rec = dict(rank=rank, coords=run.mesh.coords, device=str(run.device),
               backend=args.backend, ranks_per_card=run.ranks_per_card, ttft_s=ttft,
               e2e_s=e2e, cache={k: list(v.shape) for k, v in cache.items()},
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
               collectives=collectives.record(),
               launches={fn.__name__: fn.launches for fn in kernels},
               seq_parallel=opt_flags.seq_parallel())
    dist.barrier()
    sys.stdout.write(json.dumps(rec) + "\n")   # one write: the ranks share the stream
    sys.stdout.flush()
    dist.destroy_process_group()
    return tokens


if __name__ == "__main__":
    main()
