"""End-to-end serving driver (port of ``examples/serve_e2e.py``): the same
requests through the DuoServe runtime under every policy, with a QoS
summary per policy, host-clock walls beside the requests' replay on the
simulator's ``HW()`` (the paper's edge-GPU cost model, not a measurement).
The policies must not change the outputs.

  python -m repro_torch.examples.serve_e2e --layers 4 --requests 6 --max-new 6
  python -m repro_torch.examples.serve_e2e --device cpu --reduced
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import (add_device_args, device_config, fit_predictor, replay,
                                  sim_fields, traces)

POLICIES = ("odf", "lfp", "mif", "duo", "duo+")


def workload(cfg, requests: int):
    """(8 traced prompts, ``requests`` served ones), squad-like, at most 32
    tokens each, from one workload stream (seed 5)."""
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    wl = PromptWorkload(squad_like(cfg.vocab), seed=5)
    traced = [p[:32] for p, _ in wl.prompts(8)]
    return traced, [p[:32] for p, _ in wl.prompts(requests)]


def serve_policies(cfg, params, stats, predictor, reqs, max_new: int,
                   log=print) -> dict:
    """Every request under every policy on ``MoEServingEngine`` (default
    sampling), each replayed on the simulator. Returns {policy: record}."""
    from repro_torch.core.qos import summarize
    from repro_torch.serving.engine import MoEServingEngine
    log(f"{'policy':8s} {'wall_ttft':>9s} {'wall_e2e':>9s} "
        f"{'sim_p50':>8s} {'sim_p95':>8s} {'hit':>5s}  tokens(first req)")
    out, ref_tokens = {}, None
    for pol in POLICIES:
        eng = MoEServingEngine(cfg, params, policy=pol, stats=stats, predictor=predictor)
        results = [eng.serve(p, max_new=max_new) for p in reqs]
        if ref_tokens is None:
            ref_tokens = results[0].tokens
        elif not (results[0].tokens == ref_tokens).all():
            raise AssertionError("policies must not change outputs")
        sims = [replay(cfg, stats, predictor, pol, r) for r in results]
        q = summarize([s.ttft for s in sims], [s.e2e for s in sims],
                      total_tokens=len(reqs) * max_new,
                      hit_rate=float(np.mean([s.hit_rate for s in sims])))
        wt = np.mean([r.ttft_wall for r in results])
        we = np.mean([r.e2e_wall for r in results])
        log(f"{pol:8s} {wt:8.2f}s {we:8.2f}s {q.p50_e2e:7.3f}s "
            f"{q.p95_e2e:7.3f}s {q.hit_rate:5.2f}  "
            f"{results[0].tokens[:6].tolist()}")
        out[pol] = dict(tokens=[r.tokens.tolist() for r in results],
                        decode_traces=[r.decode_trace.tolist() for r in results],
                        prefill_active=[r.prefill_active for r in results],
                        hits=[r.hits for r in results], misses=[r.misses for r in results],
                        sims=[sim_fields(s) for s in sims], summary=q.row(),
                        wall_ttft_s=float(wt), wall_e2e_s=float(we))
        del eng
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=6)
    add_device_args(ap)
    args = ap.parse_args(argv)
    cfg, device = device_config(ap, args, args.arch)

    from repro_torch.models.params import init_params
    params = init_params(cfg, seed=0, device=device)
    traced, reqs = workload(cfg, args.requests)
    tracer, stats = traces(cfg, params, traced, max_new=6)
    predictor, _ = fit_predictor(cfg, tracer, stats, width_scale=0.1, epochs=5, batch=32,
                                 device=device)
    return serve_policies(cfg, params, stats, predictor, reqs, args.max_new)


if __name__ == "__main__":
    main()
