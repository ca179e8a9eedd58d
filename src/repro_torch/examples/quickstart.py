"""Quickstart: serve one request through DuoServe-MoE end to end (port of
``examples/quickstart.py``).

Builds a Mixtral-class MoE, runs the offline preprocess (trace ->
popularity/affinity -> ExpertMLP), then serves a prompt with the dual-phase
scheduler and replays it on the two-stream simulator against the ODF
baseline, on ``HW()``: the paper's edge-GPU cost model, not a measurement.

  python -m repro_torch.examples.quickstart --layers 4
  python -m repro_torch.examples.quickstart --device cpu --reduced
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import (add_device_args, device_config, fit_predictor, replay,
                                  sim_fields, traces)


def workload(cfg):
    """The example's 10 squad-like prompts of at most 32 tokens: 8 traced,
    the last one served."""
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    wl = PromptWorkload(squad_like(cfg.vocab), seed=1)
    return [p[:32] for p, _ in wl.prompts(10)]


def serve_and_replay(cfg, params, stats, predictor, prompt, log=print) -> dict:
    """One ``duo`` request on ``MoEServingEngine`` (default sampling, as the
    reference), then its replay at Mixtral-8x7B depth under odf and duo.
    Returns the record: tokens, hits, misses, traces, the simulator's
    results."""
    from repro_torch.core.simulator import HW
    from repro_torch.serving.engine import MoEServingEngine
    log("\n[online] serving with DuoServe dual-phase scheduling ...")
    eng = MoEServingEngine(cfg, params, policy="duo", stats=stats, predictor=predictor)
    r = eng.serve(prompt, max_new=8)
    log(f"  generated tokens: {r.tokens.tolist()}")
    log(f"  decode cache hits={r.hits} misses={r.misses}")

    log(f"\n[replay] two-stream simulator @ Mixtral-8x7B scale (AWQ 4bit) on "
        f"HW() = {HW().name}, the paper's edge-GPU cost model:")
    sims = {}
    for pol in ("odf", "duo"):
        s = replay(cfg, stats, predictor, pol, r)
        sims[pol] = sim_fields(s)
        log(f"  {pol:4s} ttft={s.ttft:.3f}s e2e={s.e2e:.3f}s "
            f"peak={s.peak_bytes / 1e9:.2f}GB decode_hit={s.hit_rate:.2f}")
    return dict(tokens=r.tokens.tolist(), hits=r.hits, misses=r.misses,
                prefill_active=r.prefill_active, decode_trace=r.decode_trace.tolist(),
                pred_trace=r.pred_trace.tolist(), ttft_wall=r.ttft_wall,
                e2e_wall=r.e2e_wall, sims=sims)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    args = ap.parse_args(argv)
    cfg, device = device_config(ap, args, "mixtral_8x7b")

    from repro_torch.models.params import init_params
    print(f"model: {cfg.name}  L={cfg.n_layers} E={cfg.n_experts} "
          f"top-k={cfg.top_k}")
    params = init_params(cfg, seed=0, device=device)
    prompts = workload(cfg)

    print("\n[offline preprocess] tracing expert activations ...")
    tracer, stats = traces(cfg, params, prompts[:8], max_new=6)
    print(f"  {len(tracer.paths)} activation paths; popularity "
          f"{stats.popularity.shape}, affinity {stats.affinity.shape}")

    print("[offline preprocess] training ExpertMLP ...")
    predictor, hist = fit_predictor(cfg, tracer, stats, width_scale=0.1, epochs=5,
                                    batch=32, device=device)
    print(f"  val top-k acc {hist['val_topk'][-1]:.2f}  "
          f"at-least-half {hist['val_half'][-1]:.2f}")

    rec = serve_and_replay(cfg, params, stats, predictor, prompts[9])
    return dict(rec, paths=int(len(tracer.paths)),
                popularity=np.asarray(stats.popularity).tolist(),
                val_topk=hist["val_topk"][-1], val_half=hist["val_half"][-1])


if __name__ == "__main__":
    main()
