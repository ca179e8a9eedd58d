"""Streaming serving demo (port of ``examples/serve_concurrent.py``):
concurrent requests through the request-handle front-end (spec -> handle ->
events) against the same requests served one by one, with token parity, a
live mid-flight cancellation, and both SLO-shedding layers: admission
rejection and the QosAutopilot's mid-flight "slo_shed" cancellation.

The serving API in three moves:

  1. Describe a request:   GenerationRequest(prompt, SamplingParams(...),
                           ttft_slo=..., tbt_slo=..., priority=...)
  2. Submit, get a handle: h = frontend.submit(spec), an iterator that
                           streams tokens as the engine emits them, with
                           .status / .result() / .cancel()
  3. Drive cooperatively:  iterating a handle (or frontend.poll()) runs the
                           engine step loop; no threads anywhere.

The batched engines decode on the dense path (``grouped_decode=False``),
the reference example's default: its arithmetic is the sequential engine's,
so the parity is bit for bit on the card too. The port's default grouped
sweep runs the expert kernel's arithmetic, which moves a decode step's
logits by about 0.04 at Mixtral-8x7B width (PERF.md §6) and so parts
greedy tokens where two logits nearly tie.

  python -m repro_torch.examples.serve_concurrent --layers 4 --smoke
  python -m repro_torch.examples.serve_concurrent --device cpu --reduced --requests 4 --max-new 5
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import add_device_args, check, device_config


def workload(cfg, requests: int):
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    wl = PromptWorkload(squad_like(cfg.vocab), seed=5)
    return [p[:16] for p, _ in wl.prompts(requests)]


def serve_concurrent(cfg, params, prompts, *, max_new: int, max_batch: int, policy: str,
                     prefill_budget=None, tbt_slo: Optional[float] = None,
                     smoke: bool = False, log=print) -> dict:
    """The demo over ``prompts``: sequential baseline, streamed batch,
    cancellation, admission shedding, the autopilot's shed. Raises on a
    broken assertion of the reference example (with ``smoke``, its smoke
    assertions too). Returns the record of what it prints."""
    from repro_torch.core.qos import AdmissionController, LatencyModel, percentile_report
    from repro_torch.serving.api import GenerationRequest, SamplingParams
    from repro_torch.serving.batching import (BatchedServingEngine, RequestQueue,
                                              parse_prefill_budget)
    from repro_torch.serving.cluster import QosAutopilot
    from repro_torch.serving.engine import MoEServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    budget = parse_prefill_budget(prefill_budget)
    rec = dict(requests=len(prompts), max_new=max_new, policy=policy)

    # sequential baseline (paper-scope engine, one request at a time)
    seq = MoEServingEngine(cfg, params, policy=policy, temperature=0.0)
    t0 = time.perf_counter()
    seq_results = [seq.serve(p, max_new=max_new) for p in prompts]
    seq_wall = time.perf_counter() - t0

    # [streaming] all requests in flight through the request-handle
    # front-end, each handle streamed round-robin so the tokens come in the
    # interleaved order the engine produces them
    dense = dict(grouped_decode=False, temperature=0.0)
    eng = BatchedServingEngine(cfg, params, policy=policy, max_batch=max_batch,
                               max_seq=64, prefill_budget=budget, tbt_slo=tbt_slo, **dense)
    fe = ServingFrontend(eng)
    t0 = time.perf_counter()
    handles = [fe.submit(GenerationRequest(
        prompt=p, params=SamplingParams(max_new_tokens=max_new),
        priority=i % 2))          # alternate priorities, just to show them
        for i, p in enumerate(prompts)]
    streams = [[] for _ in handles]
    iters = [iter(h) for h in handles]
    live = list(range(len(handles)))
    while live:
        for i in list(live):
            try:
                streams[i].append(next(iters[i]))
            except StopIteration:
                live.remove(i)
    batch_wall = time.perf_counter() - t0

    log(f"{len(prompts)} requests, max_new={max_new}, policy={policy}")
    ok = True
    rec["streams"] = []
    for i, (h, s) in enumerate(zip(handles, seq_results)):
        same = bool(np.array_equal(np.asarray(streams[i]), s.tokens))
        ok &= same
        rec["streams"].append(dict(streamed=streams[i], sequential=s.tokens.tolist(),
                                   status=h.status, reason=h.finish_reason,
                                   match_sequential=same))
        log(f"  req{i}: streamed={streams[i]} status={h.status} "
            f"reason={h.finish_reason} match_sequential={same}")
    ttfts = [h.result().ttft_wall for h in handles]
    log(f"sequential wall: {seq_wall:6.2f}s   "
        f"streamed wall: {batch_wall:6.2f}s "
        f"({seq_wall / max(batch_wall, 1e-9):.2f}x)")
    log(f"streamed TTFT: {percentile_report(ttfts)}  "
        f"mean decode batch: {np.mean(eng.decode_batch_hist):.2f}")
    rec.update(sequential_wall_s=seq_wall, streamed_wall_s=batch_wall,
               streamed_ttft_s=ttfts, mean_decode_batch=float(np.mean(eng.decode_batch_hist)))
    check(ok, "streamed tokens diverged from sequential")

    # [cancellation] a fresh batch; one request is cancelled after its
    # second token: its KV slot and expert budget free at once, and the
    # survivor's tokens stay bit-identical to its sequential run
    if len(prompts) < 2 or max_new < 2:
        log("cancellation demo skipped (needs --requests >= 2 and "
            "--max-new >= 2)")
    else:
        eng2 = BatchedServingEngine(cfg, params, policy=policy, max_batch=2, max_seq=64,
                                    prefill_budget=budget, tbt_slo=tbt_slo, **dense)
        fe2 = ServingFrontend(eng2)
        survivor = fe2.submit(GenerationRequest(
            prompt=prompts[0], params=SamplingParams(max_new_tokens=max_new)))
        victim = fe2.submit(GenerationRequest(
            prompt=prompts[1], params=SamplingParams(max_new_tokens=max_new)))
        while len(victim.tokens) < 2 and not victim.done:
            fe2.poll()
        t_req = time.perf_counter()
        check(victim.cancel(), "the victim's cancel was refused")
        t_cancel = victim.events[-1].t - t_req
        fe2.drain()
        surv_ok = bool(np.array_equal(survivor.result().tokens, seq_results[0].tokens))
        freed = victim.req.slot in eng2._free
        log(f"cancellation demo: victim cancelled after "
            f"{len(victim.tokens)} tokens in {t_cancel * 1e3:.2f}ms "
            f"(slot freed: {freed}); survivor bit-exact: {surv_ok}")
        rec["cancel"] = dict(victim_tokens=len(victim.tokens), cancel_ms=t_cancel * 1e3,
                             slot_freed=freed, survivor_exact=surv_ok,
                             reason=victim.finish_reason)
        check(surv_ok, "cancellation perturbed the surviving request")
        check(victim.finish_reason == "cancelled", "the victim did not end cancelled")

    # [SLO shedding] admission: a pessimistic cost model and a tight
    # deadline make the queue reject the request before it takes a KV slot;
    # the QosAutopilot sheds an admitted request whose deadline became
    # unmeetable mid-flight (reason "slo_shed")
    queue = RequestQueue(AdmissionController(
        LatencyModel(prefill_per_token=10.0), default_ttft_slo=1.0))
    shed = BatchedServingEngine(cfg, params, policy=policy, max_batch=2, max_seq=64,
                                queue=queue, **dense)
    fe3 = ServingFrontend(shed)
    doomed = fe3.submit(GenerationRequest(
        prompt=prompts[0], params=SamplingParams(max_new_tokens=2)))
    fe3.poll()
    log(f"SLO demo: {len(queue.rejected)} request(s) shed at admission "
        f"(predicted TTFT over a 1s deadline); handle status: "
        f"{doomed.status}")

    fe4 = ServingFrontend(BatchedServingEngine(
        cfg, params, policy=policy, max_batch=2, max_seq=64, **dense))
    autopilot = QosAutopilot(fe4)
    laggard = fe4.submit(GenerationRequest(
        prompt=prompts[0], params=SamplingParams(max_new_tokens=16), tbt_slo=0.3))
    while len(laggard.tokens) < 2 and not laggard.done:
        fe4.poll()
    # scan with a clock far past the next token's 300 ms deadline; in a
    # deployment the poll loop's own wall clock does this
    fe4.poll(time.perf_counter() + 100.0)
    log(f"autopilot demo: laggard shed mid-decode after "
        f"{len(laggard.tokens)} tokens (reason={laggard.finish_reason}, "
        f"shed counts={autopilot.by_reason}, engine n_slo_shed="
        f"{fe4.engine.n_slo_shed})")
    rec["shed"] = dict(rejected=len(queue.rejected), doomed_status=doomed.status,
                       doomed_reason=doomed.finish_reason,
                       laggard_tokens=len(laggard.tokens),
                       laggard_reason=laggard.finish_reason,
                       by_reason=dict(autopilot.by_reason), n_shed=autopilot.n_shed,
                       engine_n_slo_shed=fe4.engine.n_slo_shed)

    if smoke:
        check(doomed.finish_reason == "rejected", "admission did not reject")
        check(laggard.finish_reason == "slo_shed", "the autopilot did not shed")
        check(autopilot.n_shed == 1, "the autopilot shed more or less than one")
        check(laggard.req.slot in fe4.engine._free, "the shed request kept its slot")
        log("serve_concurrent smoke OK")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--policy", default="duo+")
    ap.add_argument("--prefill-budget", default=None,
                    help="prompt tokens of chunked prefill per engine step "
                         "(stall-free interleaving), or 'auto' to derive "
                         "the chunk from the live LatencyModel via "
                         "--tbt-slo; default monolithic")
    ap.add_argument("--tbt-slo", type=float, default=None,
                    help="target inter-token gap (s) for auto budget")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run for CI: small workload, chunked "
                         "prefill, asserts parity + cancellation safety")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.max_new = 3, 3
        args.prefill_budget = args.prefill_budget or "2"
    cfg, device = device_config(ap, args, args.arch)

    from repro_torch.models.params import init_params
    params = init_params(cfg, seed=0, device=device)
    return serve_concurrent(cfg, params, workload(cfg, args.requests),
                            max_new=args.max_new, max_batch=args.max_batch,
                            policy=args.policy, prefill_budget=args.prefill_budget,
                            tbt_slo=args.tbt_slo, smoke=args.smoke)


if __name__ == "__main__":
    main()
