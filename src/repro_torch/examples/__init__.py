"""The reference's examples on the port (``examples/*.py`` of the JAX package).

Each runs as ``python -m repro_torch.examples.<name>`` with the reference
example's arguments and defaults, plus ``--device`` (``cuda`` by default),
``--reduced`` (the CPU-sized config the reference example always runs:
head_dim 32, so CPU only) and ``--layers`` (a depth cut). On the card a
config runs at its published widths; a run that asks for a card that is not
there, or for a head_dim the CUDA kernels lack, is refused, never moved to
the CPU.

  * ``preprocess_pipeline`` — traces, popularity / affinity, the ExpertMLP,
    and the artifacts (``.npz``, loadable by either package).
  * ``quickstart`` — offline preprocess, one ``duo`` request, the
    two-stream replay on the simulator's edge-GPU model.
  * ``serve_e2e`` — five policies on the same requests.
  * ``train_moe`` — ``make_train_step`` with microbatches, AdamW, a
    checkpoint.
  * ``serve_concurrent`` — streaming handles, cancel, SLO shedding.
  * ``serve_cluster`` — replicas behind a router, disaggregation, drain,
    prefix affinity.

Each splits into ``main(argv=None)``, which parses and builds, and a
function that takes the config, the params (and the trace statistics and
predictor where the example serves with them) and returns what the example
prints as a record, so a caller can hand it other weights.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch.launch.serve import KERNEL_HEAD_DIMS, resolve_config


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized variant (CPU only: head_dim 32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")


def check(ok: bool, message: str) -> None:
    """An example's own assertion, held under ``python -O`` too."""
    if not ok:
        raise AssertionError(message)


def serving_misfit(cfg) -> Optional[str]:
    if cfg.hd not in KERNEL_HEAD_DIMS:
        return (f"head_dim {cfg.hd} is outside the CUDA attention kernels' "
                f"{KERNEL_HEAD_DIMS}")
    return None


def device_config(ap: argparse.ArgumentParser, args, arch: str,
                  misfit: Callable = serving_misfit):
    """(config, device) of a run: ``--arch`` resolved, reduced and cut as
    asked; ``ap.error`` when the card is missing or cannot run it."""
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu (with --reduced)")
    try:
        cfg = resolve_config(arch, use_reduced=args.reduced, layers=args.layers)
    except ValueError as e:
        ap.error(str(e))
    why = misfit(cfg) if device.type == "cuda" else None
    if why:
        ap.error(f"{cfg.name}: {why}; on the card run the published widths "
                 "and cut depth with --layers")
    return cfg, device


def traces(cfg, params, prompts, max_new: int):
    """ODF traces over ``prompts`` (``collect_traces``) and their
    popularity / affinity statistics: (tracer, stats)."""
    from repro_torch.serving.engine import collect_traces
    tracer, _ = collect_traces(cfg, params, prompts, max_new=max_new)
    return tracer, tracer.stats()


def fit_predictor(cfg, tracer, stats, *, width_scale: float, epochs: int, device,
                  batch: int = 256, verbose: bool = False):
    """The ExpertMLP trained on the traces (seed 1): (predictor, history)."""
    from repro_torch.core.predictor import train_predictor
    from repro_torch.core.state import StateConstructor
    X, Y = StateConstructor(stats).build_dataset(tracer.as_array())
    return train_predictor(1, X, Y, cfg.top_k, width_scale=width_scale, epochs=epochs,
                           batch=batch, verbose=verbose, device=device)


def replay(cfg, stats, predictor, policy: str, result):
    """One served request replayed by the two-stream simulator at
    Mixtral-8x7B's full depth (AWQ 4-bit expert bytes) on ``HW()``, the
    paper's edge-GPU cost model: the trace is projected onto the full
    depth by tiling its layers. Returns the ``SimResult``."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core.scheduler import make_scheduler
    from repro_torch.core.simulator import HW, ModelCosts, simulate_request
    from repro_torch.core.state import StateConstructor
    full = get_config("mixtral_8x7b")
    costs = ModelCosts(full, quant_bytes=0.5)
    fstats = stats.tiled(full.n_layers)
    sched = make_scheduler(policy, full.n_layers, full.n_experts, full.top_k,
                           int(costs.expert_bytes), stats=fstats, predictor=predictor,
                           state_constructor=StateConstructor(fstats))
    reps = full.n_layers // cfg.n_layers
    pa = (result.prefill_active * reps)[: full.n_layers]
    dt = np.tile(result.decode_trace, (1, reps, 1))[:, : full.n_layers]
    return simulate_request(sched, costs, HW(), pa, dt, seq_len=256)


def sim_fields(s) -> dict:
    """A ``SimResult`` as plain numbers."""
    return dict(policy=s.policy, ttft=s.ttft, e2e=s.e2e, peak_bytes=s.peak_bytes,
                hit_rate=s.hit_rate, step_latencies=[float(t) for t in s.step_latencies])
