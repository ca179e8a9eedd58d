"""The port's serving runtime: spec -> handle -> events -> cluster (the
public surface of ``repro.serving``, on PyTorch).

  * ``cluster`` — ``ReplicaPool`` of N ``BatchedServingEngine`` replicas
    behind a ``Router`` (``ROUTERS``: round_robin, least_loaded,
    slo_headroom, expert_affinity, prefix_affinity, disagg), the
    ``ClusterFrontend`` over it, and the ``QosAutopilot`` (mid-flight SLO
    sheds, priority preemption by pause / resume). ``ReplicaPool.drain``
    migrates a replica's requests to the others.
  * ``api`` — ``SamplingParams``, ``GenerationRequest``, the events
    ``TokenEvent`` / ``FinishEvent`` / ``RejectEvent`` grouped per step as
    ``StepEvents``, and ``RequestSnapshot`` (a paused request with its KV
    rows as host tensors).
  * ``frontend`` — ``ServingFrontend``: ``submit -> RequestHandle``,
    cooperative ``poll()``, cancel, pause / resume.
  * ``batching`` — the continuous-batching engine the frontends drive.
  * ``engine`` — ``EngineCore`` and the single-request
    ``MoEServingEngine``.

Determinism contract: at temperature 0, handle streams under any poll()
schedule, ``run_until_drained()`` and a ``ClusterFrontend`` of any replica
count under any router give the same tokens for the same prompt. On the
card this needs every kernel's arithmetic to be independent of which
requests share a batch: ``flash_decode`` cuts the cache into slot ranges
from the KV heads and ``max_seq`` alone (``kernels/flash_decode.py
n_splits``), so this holds at any ``max_seq``.

    pool = ReplicaPool.build(cfg, params, overrides=[{"role": "prefill"},
                             {"role": "decode"}], max_batch=8, max_seq=2048)
    fe = ClusterFrontend(pool, router="disagg")
    toks = list(fe.submit(prompt, params=SamplingParams(max_new_tokens=32)))
"""
from repro_torch.serving.api import (Event, FinishEvent,  # noqa: F401
                                     GenerationRequest, RejectEvent,
                                     RequestSnapshot, SamplingParams,
                                     StepEvents, TokenEvent)
from repro_torch.serving.cluster import (ClusterFrontend,  # noqa: F401
                                         DisaggRouter, QosAutopilot,
                                         ReplicaPool, Router, ROUTERS,
                                         make_router)
from repro_torch.serving.engine import (EngineCore,  # noqa: F401
                                        MoEServingEngine, RequestResult,
                                        collect_traces)
from repro_torch.serving.frontend import (RequestHandle,  # noqa: F401
                                          ServingFrontend)
