"""Training launcher on one device (port of ``repro.launch.train`` without
its pod tooling: mesh, partitioner and ``--dry-run-devices`` have no
single-card counterpart).

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
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.launch.serve import resolve_config

# families whose forward needs a frontend's inputs beside the tokens
FRONTEND_FAMILIES = {"vlm": "patch_embeds", "encdec": "frames"}


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
    args = ap.parse_args(argv)

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import AdamW, cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    cfg = resolve_config(args.arch, use_reduced=args.reduced, layers=args.layers)
    device = torch.device(args.device)
    if cfg.family in FRONTEND_FAMILIES:
        ap.error(f"{cfg.name}: the {cfg.family} family's forward needs "
                 f"'{FRONTEND_FAMILIES[cfg.family]}' beside the tokens, and this "
                 "launcher's batches are tokens only; train it through "
                 "make_train_step with that input")
    misfit = kernel_misfit(cfg) if device.type == "cuda" else None
    if misfit:
        ap.error(f"{cfg.name}: {misfit}; run it with --device cpu")
    B = args.batch or (4 if args.reduced else 2)
    S = args.seq or (32 if args.reduced else 2048)
    if B % args.microbatches:
        ap.error(f"--batch {B} does not split into {args.microbatches} microbatches")

    bundle = build(cfg)
    params = bundle.init(0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params / 1e6:.1f}M "
          f"batch={B} seq={S} microbatches={args.microbatches} device={device}")
    opt = AdamW(lr=cosine_schedule(2e-3, warmup=10, total=args.steps))
    opt_state = opt.init(params)
    step = make_train_step(bundle, opt, microbatches=args.microbatches)
    it = SyntheticLM(cfg.vocab, seed=0).batches(B, S)
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


if __name__ == "__main__":
    main()
