"""Training driver example (port of ``examples/train_moe.py``): train a
Qwen2-MoE-family model with the full substrate (sort + capacity dispatch,
load-balance aux, AdamW under a cosine schedule, microbatch accumulation,
checkpointing). The step is eager: autograd through the bundle's forward,
the attention and expert kernels' ``autograd.Function``s on the card.

  python -m repro_torch.examples.train_moe --layers 4 --steps 10
  python -m repro_torch.examples.train_moe --device cpu --reduced --steps 100
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.examples import add_device_args, device_config


def train(cfg, params, *, steps: int, batch: int, seq: int, microbatches: int,
          log=print) -> dict:
    """``steps`` AdamW steps of ``make_train_step`` on ``SyntheticLM``
    batches (seed 0), ``cosine_schedule(2e-3, warmup=10, total=steps)``;
    ``params`` are updated in place. Returns the per-step losses, aux
    losses, gradient norms and walls."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import make_train_step

    device = params["embed"].device
    opt = AdamW(lr=cosine_schedule(2e-3, warmup=10, total=steps))
    opt_state = opt.init(params)
    step = make_train_step(build(cfg), opt, microbatches=microbatches)
    it = SyntheticLM(cfg.vocab, seed=0).batches(batch, seq)
    rec = dict(loss=[], aux=[], grad_norm=[], wall_s=[])
    t0 = time.time()
    for i in range(steps):
        tb = time.perf_counter()
        batch_t = {"tokens": torch.from_numpy(next(it)).to(device)}
        params, opt_state, m = step(params, opt_state, batch_t)
        for k in ("loss", "aux", "grad_norm"):
            rec[k].append(float(m[k]))
        rec["wall_s"].append(time.perf_counter() - tb)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d}  loss {rec['loss'][-1]:.4f}  "
                f"aux {rec['aux'][-1]:.4f}  "
                f"|g| {rec['grad_norm'][-1]:.2f}  "
                f"{(i + 1) / (time.time() - t0):.2f} it/s")
    return params, rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default="/tmp/duoserve_train.npz")
    add_device_args(ap)
    args = ap.parse_args(argv)

    from repro_torch.launch.train import kernel_misfit
    cfg, device = device_config(ap, args, args.arch, misfit=kernel_misfit)
    if args.batch % args.microbatches:
        ap.error(f"--batch {args.batch} does not split into {args.microbatches} "
                 "microbatches")

    from repro_torch.models.model import build
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves
    params = build(cfg).init(0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params "
          f"(E={cfg.n_experts} top-{cfg.top_k} + {cfg.n_shared_experts} shared)")
    params, rec = train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
                        microbatches=args.microbatches)
    checkpoint.save(args.ckpt, params, extra={"steps": args.steps})
    print("checkpoint ->", args.ckpt)
    return dict(rec, n_params=n_params, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
