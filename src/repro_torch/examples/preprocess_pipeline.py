"""Offline preprocess pipeline (paper Fig. 3, left; port of
``examples/preprocess_pipeline.py``): dataset slice -> Experts Tracer ->
popularity/affinity matrices -> ExpertMLP training -> serialized artifacts
ready for the inference runtime.

The artifacts are the reference's formats, so either package loads what the
other wrote: ``model.npz`` and ``predictor.npz`` through
``training/checkpoint.py`` (the predictor as the reference's
``{"params": [...], "bn": [...]}`` lists), ``trace_stats.npz`` through
``TraceStats.save``.

  python -m repro_torch.examples.preprocess_pipeline --layers 4 --out /tmp/duoserve
  python -m repro_torch.examples.preprocess_pipeline --device cpu --reduced
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import add_device_args, device_config, fit_predictor, traces


def workload(cfg, dataset: str, requests: int):
    """``requests`` prompts of the dataset's shape, at most 40 tokens each
    (seed 3)."""
    from repro_torch.data.pipeline import PromptWorkload, orca_like, squad_like
    spec = (squad_like if dataset == "squad" else orca_like)(cfg.vocab)
    return [p[:40] for p, _ in PromptWorkload(spec, seed=3).prompts(requests)]


def preprocess(cfg, params, prompts, out: str, *, epochs: int, device,
               log=print) -> dict:
    """Trace ``prompts`` (8 new tokens each), save the statistics, train the
    ExpertMLP (width 0.25) and save it, all into ``out``. Returns the
    record: the paths, the statistics, the training history, the predictor,
    the files."""
    from repro_torch.training import checkpoint
    log(f"[1/3] tracing {len(prompts)} requests on {cfg.name} ...")
    tracer, stats = traces(cfg, params, prompts, max_new=8)
    stats_path = os.path.join(out, "trace_stats.npz")
    stats.save(stats_path)
    entropy = (-stats.popularity * np.log(stats.popularity + 1e-9)).sum(1)
    log(f"  paths={len(tracer.paths)}  popularity entropy/layer={entropy.round(2)}")

    log("[2/3] building supervised dataset + training ExpertMLP ...")
    pred, hist = fit_predictor(cfg, tracer, stats, width_scale=0.25, epochs=epochs,
                               device=device, verbose=True)
    pparams, bn_state = pred.model.reference_tree()
    pred_path = os.path.join(out, "predictor.npz")
    checkpoint.save(pred_path, {"params": pparams, "bn": bn_state},
                    extra={"top_k": pred.top_k})

    log("[3/3] artifacts written to", out)
    log("  final val top-k acc:", round(hist["val_topk"][-1], 3),
        " at-least-half:", round(hist["val_half"][-1], 3))
    return dict(paths=tracer.as_array(), popularity=stats.popularity,
                affinity=stats.affinity, entropy=entropy, history=hist, predictor=pred,
                files=dict(trace_stats=stats_path, predictor=pred_path))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--dataset", default="squad", choices=["squad", "orca"])
    ap.add_argument("--out", default="/tmp/duoserve_preprocess")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=6)
    add_device_args(ap)
    args = ap.parse_args(argv)
    cfg, device = device_config(ap, args, args.arch)
    os.makedirs(args.out, exist_ok=True)

    from repro_torch.models.params import init_params
    from repro_torch.training import checkpoint
    params = init_params(cfg, seed=0, device=device)
    model_path = os.path.join(args.out, "model.npz")
    checkpoint.save(model_path, params, extra={"arch": cfg.name})
    rec = preprocess(cfg, params, workload(cfg, args.dataset, args.requests), args.out,
                     epochs=args.epochs, device=device)
    rec["files"]["model"] = model_path
    return rec


if __name__ == "__main__":
    main()
