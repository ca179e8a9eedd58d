"""Cluster serving demo (port of ``examples/serve_cluster.py``): N engine
replicas behind a QoS-aware router, with the SLO autopilot shedding doomed
requests mid-flight.

The cluster layer in three moves (serving/cluster.py):

  1. Build replicas:  pool = ReplicaPool.build(cfg, params, n_replicas,
                      ...): each replica is a full BatchedServingEngine
                      with its own KV slots, queue and ExpertResidency.
  2. Pick a router:   fe = ClusterFrontend(pool, router="slo_headroom")
                      round_robin | least_loaded | slo_headroom |
                      expert_affinity; the submit() surface is the plain
                      ServingFrontend's.
  3. Close the loop:  QosAutopilot(fe): after every poll, requests whose
                      TTFT/TBT deadline is already unmeetable are shed
                      (FinishEvent reason="slo_shed").

Plus the moves built on the KV snapshot primitive: a phase-disaggregated
pool (a prefill and a decode replica, router="disagg"), draining a replica
mid-flight, and prefix caching with router="prefix_affinity"; each must
give the plain front-end's tokens.

  python -m repro_torch.examples.serve_cluster --layers 4 --smoke
  python -m repro_torch.examples.serve_cluster --device cpu --reduced --replicas 2 --requests 6
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import add_device_args, check, device_config


def workload(cfg, requests: int):
    """Alternating long (24) and short (8) random prompts, and the rng that
    drew them (the prefix demo draws its suffix from it)."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, size=(24 if i % 2 == 0 else 8)).astype(np.int32)
            for i in range(requests)], rng


def serve_cluster(cfg, params, prompts, rng, *, replicas: int, router: str, max_new: int,
                  max_batch: int, policy: str, prefill_budget="2",
                  trace_out: Optional[str] = None, smoke: bool = False,
                  log=print) -> dict:
    """The demo over ``prompts``: routed cluster, 1-replica parity, the
    autopilot's shed, disaggregation, drain, prefix affinity. Raises on a
    broken assertion of the reference example. Returns the record of what
    it prints."""
    from repro_torch.serving.api import GenerationRequest, SamplingParams
    from repro_torch.serving.batching import BatchedServingEngine, parse_prefill_budget
    from repro_torch.serving.cluster import ClusterFrontend, QosAutopilot, ReplicaPool
    from repro_torch.serving.frontend import ServingFrontend

    def spec(p, n=max_new, **kw):
        return GenerationRequest(prompt=p, params=SamplingParams(max_new_tokens=n), **kw)

    kw = dict(policy=policy, max_batch=max_batch, max_seq=64,
              prefill_budget=parse_prefill_budget(prefill_budget), temperature=0.0)
    rec = dict(requests=len(prompts), replicas=replicas, router=router, policy=policy)

    # [cluster] every request routed across the replicas and streamed
    pool = ReplicaPool.build(cfg, params, replicas, **kw)
    fe = ClusterFrontend(pool, router=router)
    autopilot = QosAutopilot(fe)
    handles = [fe.submit(spec(p, ttft_slo=60.0)) for p in prompts]
    t0 = time.perf_counter()
    fe.drain()
    wall = time.perf_counter() - t0
    log(f"{len(prompts)} requests over {replicas} replicas, "
        f"router={router}, policy={policy}")
    for i, h in enumerate(handles):
        log(f"  req{i} (len {len(prompts[i]):2d}) -> replica "
            f"{h.replica}: tokens={list(h.tokens)} "
            f"reason={h.finish_reason}")
    balance = [sum(1 for h in handles if h.replica == i) for i in range(replicas)]
    log(f"balance={balance}  wall={wall:.2f}s  "
        f"autopilot shed={autopilot.n_shed}")
    hbm = []
    for i, eng in enumerate(pool.engines):
        res = eng.cache
        hbm.append(res.hbm_bound_ok)
        log(f"  replica {i}: expert HBM {res.device_bytes / 2**20:.2f} "
            f"MiB == {res.pool_capacity} x "
            f"{res.bytes_per_expert / 2**20:.2f} MiB bound: "
            f"{'ok' if res.hbm_bound_ok else 'VIOLATED'}")
    rec["cluster"] = dict(replica=[h.replica for h in handles],
                          tokens=[list(h.tokens) for h in handles],
                          reasons=[h.finish_reason for h in handles], balance=balance,
                          wall_s=wall, shed=autopilot.n_shed, hbm_bound_ok=hbm)
    check(all(hbm), "per-replica expert-HBM bound violated")
    check(all(h.finish_reason == "length" for h in handles), "a request did not run out")

    # [parity] a 1-replica cluster is the plain front-end, bit for bit
    base = ServingFrontend(BatchedServingEngine(cfg, params, **kw))
    ref = [base.submit(spec(p)) for p in prompts]
    base.drain()
    one = ClusterFrontend(ReplicaPool.build(cfg, params, 1, **kw), router=router)
    got = [one.submit(spec(p)) for p in prompts]
    one.drain()
    parity = all(list(r.tokens) == list(g.tokens) for r, g in zip(ref, got))
    log(f"1-replica cluster bit-exact vs ServingFrontend: {parity}")
    rec["plain_tokens"] = [list(r.tokens) for r in ref]
    rec["one_replica_parity"] = parity
    check(parity, "1-replica cluster diverged from the plain front-end")

    # [autopilot] a deterministic mid-flight shed: a decoding request with
    # a 60 s TBT target, scanned with a clock 100 s ahead, so its next
    # token's deadline has passed
    victim = fe.submit(spec(prompts[0], 16, tbt_slo=60.0))
    while len(victim.tokens) < 2 and not victim.done:
        fe.poll()
    fe.poll(time.perf_counter() + 100.0)
    owner = pool.engines[victim.replica]
    freed = victim.req.slot in owner._free
    log(f"autopilot demo: victim shed after {len(victim.tokens)} tokens "
        f"(reason={victim.finish_reason}, slot freed: "
        f"{freed}, engine n_slo_shed="
        f"{owner.n_slo_shed})")
    rec["autopilot"] = dict(victim_tokens=len(victim.tokens), reason=victim.finish_reason,
                            slot_freed=freed, engine_n_slo_shed=owner.n_slo_shed)
    check(victim.finish_reason == "slo_shed", "the autopilot did not shed the victim")
    check(freed, "the shed request kept its slot")
    fe.drain()

    # [disagg] a prefill and a decode replica: each finished prefill's KV
    # prefix is handed to the decode replica, the handle follows it
    dpool = ReplicaPool.build(cfg, params, spans=trace_out is not None,
                              overrides=[{"role": "prefill"}, {"role": "decode"}], **kw)
    dfe = ClusterFrontend(dpool, router="disagg")
    dhs = [dfe.submit(spec(p)) for p in prompts]
    dfe.drain()
    for r, g in zip(ref, dhs):
        check(list(r.tokens) == list(g.tokens), "disagg diverged")
        check(bool(g.handoffs) and g.replica == 1, "a request was not handed off")
    log(f"disagg 1p+1d: {dpool.n_handoffs} prefill->decode handoffs "
        f"({dpool.handoff_bytes / 2**10:.1f} KiB host KV moved), "
        f"tokens bit-exact vs plain front-end")
    rec["disagg"] = dict(tokens=[list(g.tokens) for g in dhs], n_handoffs=dpool.n_handoffs,
                         handoff_bytes=dpool.handoff_bytes)
    if trace_out:
        from repro_torch.obs.chrome_trace import write_trace
        trace = write_trace(trace_out, dpool.recorders())
        log(f"wrote {trace_out} ({len(trace['traceEvents'])} events) "
            "- open at https://ui.perfetto.dev")
        rec["disagg"]["trace_events"] = len(trace["traceEvents"])

    # [drain] a replica taken out of service mid-flight: its requests
    # migrate to the survivor through the same snapshot primitive
    pool2 = ReplicaPool.build(cfg, params, 2, **kw)
    fe2 = ClusterFrontend(pool2, router="round_robin")
    hs2 = [fe2.submit(spec(p)) for p in prompts]
    fe2.poll()
    fe2.poll()
    pool2.drain(0)
    fe2.drain()
    check(pool2.engines[0].idle and 0 not in pool2.routable(),
          "the drained replica is not empty and out of the route")
    for r, g in zip(ref, hs2):
        check(list(r.tokens) == list(g.tokens), "drain migration diverged")
    log(f"drain: replica 0 emptied mid-flight ({pool2.n_migrated} "
        f"requests migrated), all streams bit-exact; routable="
        f"{pool2.routable()}")
    rec["drain"] = dict(tokens=[list(g.tokens) for g in hs2], n_migrated=pool2.n_migrated,
                        routable=pool2.routable())
    pool2.undrain(0)

    # [prefix] two requests share prompts[0] as a template (the second
    # appends a short suffix): the first's retired slot seeds the second's
    # admission, and prefix_affinity steers it to the warm replica
    follow = np.concatenate([prompts[0], rng.integers(0, cfg.vocab, size=4,
                                                      dtype=np.int64).astype(np.int32)])
    pref_refs = []
    for p in (prompts[0], follow):
        cold = ServingFrontend(BatchedServingEngine(cfg, params, **kw))
        h = cold.submit(spec(p))
        cold.drain()
        pref_refs.append(list(h.tokens))
    ppool = ReplicaPool.build(cfg, params, 2, prefix_cache=True, **kw)
    pfe = ClusterFrontend(ppool, router="prefix_affinity")
    ph0 = pfe.submit(spec(prompts[0]))
    pfe.drain()
    ph1 = pfe.submit(spec(follow))
    pfe.drain()
    check(list(ph0.tokens) == pref_refs[0], "prefix reuse diverged")
    check(list(ph1.tokens) == pref_refs[1], "prefix reuse diverged")
    check(ph1.replica == ph0.replica, "follower missed the warm replica")
    warm_eng = ppool.engines[ph1.replica]
    check(warm_eng.prefix.hit_tokens >= len(prompts[0]) - 1, "the template was not reused")
    log(f"prefix cache: follower reused {warm_eng.prefix.hit_tokens} "
        f"cached tokens on replica {ph1.replica} "
        f"(prefilled {warm_eng.prefilled_tokens} of "
        f"{len(prompts[0]) + len(follow)} prompt tokens), bit-exact "
        f"vs cold prefill")
    rec["prefix"] = dict(tokens=[list(ph0.tokens), list(ph1.tokens)], replica=ph1.replica,
                         hit_tokens=warm_eng.prefix.hit_tokens,
                         prefilled_tokens=warm_eng.prefilled_tokens)
    if smoke:
        log("serve_cluster smoke OK")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--router", default="slo_headroom")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--policy", default="duo+")
    ap.add_argument("--prefill-budget", default="2")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run for CI: asserts 1-replica parity "
                         "vs the plain front-end, the per-replica expert-"
                         "HBM bound, and a deterministic autopilot shed")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/chrome://tracing JSON timeline "
                         "of the disagg demo (open at ui.perfetto.dev)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.max_new = 4, 3
    cfg, device = device_config(ap, args, args.arch)

    from repro_torch.models.params import init_params
    params = init_params(cfg, seed=0, device=device)
    prompts, rng = workload(cfg, args.requests)
    return serve_cluster(cfg, params, prompts, rng, replicas=args.replicas,
                         router=args.router, max_new=args.max_new,
                         max_batch=args.max_batch, policy=args.policy,
                         prefill_budget=args.prefill_budget, trace_out=args.trace_out,
                         smoke=args.smoke)


if __name__ == "__main__":
    main()
