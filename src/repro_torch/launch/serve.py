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
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from repro_torch.configs.base import get_config, reduced
from repro_torch.configs.paper_models import PAPER_MODELS

POLICIES = ("odf", "lfp", "mif", "duo", "duo+")
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
    args = ap.parse_args(argv)

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
        r = eng.serve(p[:32], max_new=args.max_new)
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


if __name__ == "__main__":
    main()
