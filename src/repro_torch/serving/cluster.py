"""Cluster serving layer: a ReplicaPool of engines behind a pluggable
Router, with the QoS autopilot that closes the SLO loop (port of
``repro.serving.cluster``, decision for decision).

The tier above ``BatchedServingEngine`` (cf. vLLM's production-stack
router): N independent engine replicas — each with its own KV slot pool,
scheduler, arrival queue, and ``ExpertResidency`` — behind a routing policy
that decides, per request, WHICH replica serves it. Because our replicas
carry phase-specialized expert caches, routing is richer than generic load
balancing: a replica whose residency already holds the request's likely
experts serves it with fewer fetches, so the router is an extension of the
paper's caching policy, not just a load spreader.

Routers (``make_router``):

  * ``round_robin``    — classic rotation; oblivious to load AND request
    size, so alternating long/short workloads systematically pile the long
    prompts onto the same replicas (the baseline the benches beat).
  * ``least_loaded``   — min outstanding work (``ReplicaLoad.total_tokens``:
    queued + prefill backlog + committed decode tokens), ties broken by
    replica index.
  * ``slo_headroom``   — route to the replica whose latency model leaves the
    MOST margin against the request's ttft/tbt SLOs
    (``AdmissionController.headroom``); reject only if NO replica is
    non-negative. SLO-less requests fall back to least-loaded ranking.
  * ``expert_affinity``— rank replicas by overlap between the request's
    likely-expert set (decode predictor with empty history when available,
    else trace popularity — fMoE's semantic-locality argument) and each
    replica's live residency ledger (``CacheState.residency_overlap``);
    load-overloaded replicas are excluded first (production-stack's
    overload-detector-then-affinity order), ties broken by load.
  * ``prefix_affinity``— rank replicas by the length of the request's
    prompt prefix already cached in each replica's ``PrefixTree``
    (``peek`` — read-only), same overload-gate-then-affinity ordering as
    ``expert_affinity``: matching requests land on the warm replica, so N
    replicas become a sharded prefix cache instead of N cold copies
    (requires engines built with ``prefix_cache=True``; degrades to
    least-loaded otherwise).
  * ``disagg``         — disaggregated prefill/decode dispatch (the paper's
    dual-phase split at cluster scale): NEW requests go to
    prefill-role replicas only; when a prefill completes, the request sits
    ``held`` until the per-poll handoff (``ReplicaPool.handoff_held``)
    snapshots its KV prefix and restores it into the decode replica with
    the best per-request expert-affinity/headroom. Per-replica ``build``
    overrides size each role differently (big dense-traffic residency
    pools for prefill, small predictor-driven ones for decode).

Every policy routes over the pool's ROUTABLE replicas: ``ReplicaPool.
drain(i)`` removes a replica from routing and migrates its in-flight
requests to the survivors via the same snapshot/restore primitive
(retried each poll; ``undrain`` reverses). All of it rides on
``BatchedServingEngine.snapshot/restore`` — a paused, handed-off, or
migrated request resumes BIT-EXACTLY (carried rng state + dense KV prefix
+ token list), so phase placement never changes tokens.

``ClusterFrontend`` keeps the exact ``ServingFrontend`` surface — ``submit(spec)
-> RequestHandle``, cooperative ``poll()`` (steps ALL replicas), handle
``.cancel()`` delegating to the owning replica — so every existing
example/bench runs on a cluster by swapping one constructor; across
handoffs/migrations the SAME handle follows the request (rebound to each
restored incarnation, hops recorded on ``handle.handoffs``). A request the
router rejects gets a terminal handle with a ``RejectEvent("router_slo")``
and never touches an engine queue.

``QosAutopilot`` attaches to either front-end (cluster or plain
``ServingFrontend``) and runs after every poll: a request whose TTFT
deadline is unmeetable (predicted remaining prefill overruns it) or whose
next-token TBT deadline has already passed is shed via ``handle.cancel
(reason="slo_shed")`` — the KV slot, residency contributions, and TBT entry
reclaimed synchronously, surfaced as ``FinishEvent(reason="slo_shed")`` and
counted on both the autopilot and the owning engine (``n_slo_shed``).
With ``preempt=True`` it also gets a RECOVERABLE action: pause the
lowest-priority in-flight request host-side when a higher-priority one is
stuck queued, and resume it bit-exactly when headroom returns.
Survivors are bit-unaffected.

Determinism: at temperature 0 a 1-replica cluster is bit-identical to a
plain ``ServingFrontend`` under every router policy, and every request
served by ANY replica of an N-replica cluster reproduces the single-request
engine's tokens (the row-wise exactness invariant composes across
replicas).

On the card every replica is its own ``BatchedServingEngine`` on the one
device: its own KV pools, ``ExpertResidency`` pools and copy stream. The
host expert slabs and the dense device weights are the shared ``params``'
own tensors (``HostExpertStore.from_params`` makes views of pinned params),
so N replicas add N residency pools and KV pools, not N copies of the
weights. A handoff or migration copies the request's KV rows to host
tensors and back (``snapshot`` / ``restore``): 2·L synchronous copies each
way.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import (Deque, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.cache import ExpertKey
from repro_torch.core.qos import AdmissionController, ReplicaLoad
from repro_torch.obs.metrics import METRICS_SCHEMA, MetricsRegistry
from repro_torch.serving.api import (GenerationRequest, RejectEvent,
                               RequestSnapshot, StepEvents, as_request_spec)
from repro_torch.serving.batching import (BatchedServingEngine, Request,
                                    RequestQueue, kv_row_bytes)
from repro_torch.serving.frontend import (CooperativeDriver, RequestHandle,
                                    ServingFrontend)


def _valid_engine_kwargs() -> frozenset:
    """Keyword names BatchedServingEngine accepts, derived from its real
    signature (so this can never drift), plus the pool-level
    ``default_ttft_slo`` knob resolved in build()."""
    import inspect

    sig = inspect.signature(BatchedServingEngine.__init__)
    names = {p.name for p in sig.parameters.values()
             if p.name not in ("self", "cfg", "params", "queue")}
    return frozenset(names | {"default_ttft_slo"})


def _validate_engine_kwargs(kwargs, where: str) -> None:
    """Reject unknown engine kwargs/override keys up front with a clear
    error (a typo'd override otherwise surfaces as a TypeError only after
    earlier replicas were already built — or, worse, silently configures
    nothing if a **kwargs sink is ever introduced)."""
    valid = _valid_engine_kwargs()
    unknown = sorted(set(kwargs) - valid)
    if not unknown:
        return
    import difflib

    parts = []
    for u in unknown:
        close = difflib.get_close_matches(u, sorted(valid), n=1)
        parts.append(f"{u!r}" + (f" (did you mean {close[0]!r}?)"
                                 if close else ""))
    raise ValueError(
        f"{where}: unknown engine kwarg(s) {', '.join(parts)}; "
        f"valid keys: {sorted(valid)}"
    )


def likely_expert_keys(engine: BatchedServingEngine,
                       width: Optional[int] = None
                       ) -> FrozenSet[ExpertKey]:
    """The decode predictor's likely-expert set for an incoming request —
    per layer, the top-`width` (default top_k) experts the replica's
    scheduler expects a fresh request to activate.

    Before a request runs there is no activation path, so the per-layer
    prediction uses the empty-history feature vector (popularity + layer
    embedding dominate) when the scheduler carries the trained ExpertMLP;
    schedulers without a predictor fall back to the trace-popularity prior
    (MIF's request-level signal), and stat-less schedulers yield the empty
    set — expert_affinity then degrades to pure load ranking. The set is a
    property of the MODEL + workload, not of a replica, so the router
    computes it once per request (all replicas share params/stats)."""
    sched = engine.sched
    width = width or engine.k
    sc = getattr(sched, "state_constructor", None)
    predictor = getattr(sched, "predictor", None)
    stats = getattr(sched, "stats", None) or (sc.stats if sc else None)
    keys: List[ExpertKey] = []
    if predictor is not None and sc is not None:
        for l in range(engine.L):
            if l == 0:
                if stats is not None:
                    top = np.argsort(-stats.popularity[0])[:width]
                    keys += [(0, int(e)) for e in top]
                continue
            feat = sc.features([], l)
            top = predictor.predict_topk(feat[None], k=width)[0]
            keys += [(l, int(e)) for e in top[:width]]
    elif stats is not None:
        for l in range(engine.L):
            top = np.argsort(-stats.popularity[l])[:width]
            keys += [(l, int(e)) for e in top]
    return frozenset(keys)


class Router:
    """Routing policy: pick the replica index for a request, or None to
    reject it outright (only ``slo_headroom`` ever rejects). Stateless
    except for policy-owned cursors, so one router instance serves one
    ClusterFrontend. Every policy ranks over ``candidates(pool)`` —
    by default the pool's routable (non-draining) replicas, which the
    DisaggRouter narrows to prefill-capable ones."""

    name = "base"

    def candidates(self, pool: "ReplicaPool") -> List[int]:
        cands = pool.routable()
        if not cands:
            raise RuntimeError("every replica is draining — nowhere to route")
        return cands

    def choose(self, spec: GenerationRequest, pool: "ReplicaPool",
               now: float) -> Optional[int]:
        raise NotImplementedError


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._cursor = 0

    def choose(self, spec, pool, now):
        cands = self.candidates(pool)
        i = cands[self._cursor % len(cands)]
        self._cursor += 1
        return i


class LeastLoadedRouter(Router):
    """Min outstanding tokens (queued + prefill backlog + committed decode);
    ties break toward the lower replica index for determinism."""
    name = "least_loaded"

    def choose(self, spec, pool, now):
        loads = pool.loads()
        return min(self.candidates(pool),
                   key=lambda i: (loads[i].total_tokens,
                                  loads[i].queue_depth, i))


class SloHeadroomRouter(Router):
    """Max SLO margin (AdmissionController.headroom) across replicas;
    reject (None) only when NO replica can meet the request's deadlines
    even from an IMMEDIATE start — the same REJECT boundary admission and
    the QosAutopilot use, so a backlog that merely has to drain first
    (admission's QUEUE band) routes to the best replica instead of being
    router-rejected. For SLO-less requests every headroom is +inf and the
    load tie-break makes this least-loaded."""
    name = "slo_headroom"

    def _scores(self, spec, pool, now, with_backlog: bool
                ) -> List[Tuple[float, int, int]]:
        arrival = spec.arrival if spec.arrival is not None else now
        plen = int(np.asarray(spec.prompt).reshape(-1).shape[0])
        loads = pool.loads()
        scored: List[Tuple[float, int, int]] = []
        for i in self.candidates(pool):
            eng, ld = pool.engines[i], loads[i]
            backlog = (ld.queued_tokens + ld.prefill_backlog
                       if with_backlog else 0)
            hr = eng.queue.admission.headroom(
                now, arrival, plen, backlog,
                ttft_slo=spec.ttft_slo, tbt_slo=spec.tbt_slo,
                running_batch=ld.running,
                chunk_budget=eng._current_budget(),
                chunk_adaptive=eng.prefill_budget == "auto")
            scored.append((hr, ld.total_tokens, i))
        return scored

    def choose(self, spec, pool, now):
        # rank by backlog-inclusive margin: the honest prediction of what
        # the request will actually experience on each replica
        best = max(self._scores(spec, pool, now, with_backlog=True),
                   key=lambda s: (s[0], -s[1], -s[2]))
        if best[0] >= 0:
            return best[2]
        # every replica breaches WITH its current backlog — reject only if
        # the deadline is hopeless even from an immediate start everywhere
        # (otherwise route to the best immediate-start replica and let its
        # admission QUEUE the request while the backlog drains)
        best0 = max(self._scores(spec, pool, now, with_backlog=False),
                    key=lambda s: (s[0], -s[1], -s[2]))
        if best0[0] < 0:
            return None   # no replica can meet the request's deadlines
        return best0[2]


class ExpertAffinityRouter(Router):
    """Max overlap between a fresh request's likely-expert set (shared
    model/workload signal, see ReplicaPool.likely_keys) and the replica's
    LIVE residency ledger, among non-overloaded replicas
    (overload first, affinity second — production-stack's ordering, which
    also breaks the warm-cache-wins-forever feedback loop); ties break by
    load then index. With no predictor/stats signal the overlap is 0
    everywhere and this degrades to least-loaded."""
    name = "expert_affinity"

    def __init__(self, overload_factor: float = 2.0):
        self.overload_factor = overload_factor

    def choose(self, spec, pool, now):
        plen = int(np.asarray(spec.prompt).reshape(-1).shape[0])
        cands = self.candidates(pool)
        loads = pool.loads()
        floor = min(loads[i].total_tokens for i in cands)
        # a replica is overloaded when its backlog exceeds the least-loaded
        # replica's by more than `overload_factor` x this request's own
        # work — affinity may then not justify the queueing it would eat
        limit = floor + self.overload_factor * max(plen, 1)
        eligible = [i for i in cands if loads[i].total_tokens <= limit]
        keys = pool.likely_keys()
        return max(eligible,
                   key=lambda i: (pool.engines[i].cache.residency_overlap(
                       keys), -loads[i].total_tokens, -i))


class PrefixAffinityRouter(Router):
    """Max cached-prefix overlap between the request's prompt and each
    replica (``BatchedServingEngine.prefix_score`` — the ``PrefixTree``'s
    current contents plus every live request's prompt, so a BURST of
    same-template arrivals co-locates even before the first one has
    prefilled; KV-side affinity, the sibling of ``expert_affinity``'s
    residency overlap), among non-overloaded replicas. The overload gate
    comes FIRST with the same factor/ordering as expert_affinity: prefix
    hits shorten prefill, which attracts more matching requests, so
    without the gate the warm-replica feedback loop would pile unbounded
    load onto one replica. Ties break by load then index; replicas
    without a prefix tree score 0, so on a cold or tree-less pool this
    degrades to least-loaded."""
    name = "prefix_affinity"

    def __init__(self, overload_factor: float = 2.0):
        self.overload_factor = overload_factor

    def choose(self, spec, pool, now):
        prompt = np.asarray(spec.prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        cands = self.candidates(pool)
        loads = pool.loads()
        floor = min(loads[i].total_tokens for i in cands)
        limit = floor + self.overload_factor * max(plen, 1)
        eligible = [i for i in cands if loads[i].total_tokens <= limit]

        # cap at plen-1 — the engine never reuses the final prompt
        # position (its logits produce the first token), so score exactly
        # the rows a hit could actually save
        cap = max(plen - 1, 0)
        return max(eligible,
                   key=lambda i: (pool.engines[i].prefix_score(prompt, cap),
                                  -loads[i].total_tokens, -i))


class DisaggRouter(Router):
    """Disaggregated prefill/decode dispatch: NEW requests go to
    prefill-capable replicas only (least-loaded among them — for a
    prefill-role replica ``total_tokens`` is pure prefill work, held
    requests' decode budgets are excluded); decode-role replicas receive
    work exclusively through the KV-snapshot handoff the ClusterFrontend
    runs each poll (``ReplicaPool.handoff_held``), which picks the decode
    replica by THIS request's own expert-affinity (overlap between its
    observed prefill activations and the replica's live residency), then
    load."""
    name = "disagg"

    def candidates(self, pool):
        cands = [i for i in pool.routable()
                 if pool.roles[i] in ("prefill", "both")]
        # dedicated prefill replicas take precedence over generalists
        pref = [i for i in cands if pool.roles[i] == "prefill"]
        cands = pref or cands
        if not cands:
            raise RuntimeError("no routable prefill-capable replica")
        return cands

    def choose(self, spec, pool, now):
        loads = pool.loads()
        return min(self.candidates(pool),
                   key=lambda i: (loads[i].total_tokens,
                                  loads[i].queue_depth, i))


ROUTERS = ("round_robin", "least_loaded", "slo_headroom", "expert_affinity",
           "prefix_affinity", "disagg")


def make_router(name: Union[str, Router]) -> Router:
    if isinstance(name, Router):
        return name
    name = name.lower()
    if name == "round_robin":
        return RoundRobinRouter()
    if name == "least_loaded":
        return LeastLoadedRouter()
    if name == "slo_headroom":
        return SloHeadroomRouter()
    if name == "expert_affinity":
        return ExpertAffinityRouter()
    if name == "prefix_affinity":
        return PrefixAffinityRouter()
    if name == "disagg":
        return DisaggRouter()
    raise KeyError(f"unknown router {name!r} (have {ROUTERS})")


class ReplicaPool:
    """N independent BatchedServingEngine replicas + their per-replica
    ServingFrontends. Replicas share NOTHING mutable: each has its own KV
    slots, arrival queue (own AdmissionController/LatencyModel — per-replica
    load signals stay honest), scheduler, and ExpertResidency; only the
    host-side params/stats/predictor objects are shared, read-only."""

    def __init__(self, engines: Sequence[BatchedServingEngine]):
        if not engines:
            raise ValueError("a pool needs at least one replica")
        for i, a in enumerate(engines):
            for b in engines[i + 1:]:
                if a.queue is b.queue:
                    raise ValueError("replicas must not share an arrival queue")
                if a.cache is b.cache:
                    raise ValueError("replicas must not share an ExpertResidency")
        self.engines = list(engines)
        self.frontends = [ServingFrontend(e) for e in self.engines]
        self.roles: List[str] = [getattr(e, "role", "both")
                                 for e in self.engines]
        self.draining: set = set()   # replica indices being drained
        # pool-level accounting lives on this registry (per-replica numbers
        # live on each engine's own ``metrics``); the n_handoffs /
        # handoff_bytes / ... attributes below are read-only views
        self.metrics = MetricsRegistry()
        self._c_handoffs = self.metrics.counter(
            "cluster_handoffs_total",
            "prefill->decode KV handoffs completed")
        self._c_migrated = self.metrics.counter(
            "cluster_migrations_total", "drain migrations completed")
        self._c_handoff_bytes = self.metrics.counter(
            "cluster_handoff_bytes_total",
            "host-side KV bytes moved by migrate()")
        self._c_handoff_saved = self.metrics.counter(
            "cluster_handoff_bytes_saved_total",
            "head bytes NOT shipped thanks to destination prefix reuse")
        self._c_tail_handoffs = self.metrics.counter(
            "cluster_tail_handoffs_total",
            "migrations that shipped only a partial KV tail")
        # stamp each engine's span recorder with its replica index so a
        # merged Perfetto export gets one process-track per replica
        for i, e in enumerate(self.engines):
            e.obs.replica = i
        self._flow_seq = 0   # Perfetto flow-arrow ids for handoff hops
        self._likely_cache: Optional[FrozenSet[ExpertKey]] = None

    # legacy counter attributes — thin read-only registry views (the
    # obs-discipline lint rejects direct writes; mutate via the counters)
    @property
    def n_handoffs(self) -> int:
        """Prefill->decode KV handoffs completed (registry view)."""
        return int(self._c_handoffs.value)

    @property
    def n_migrated(self) -> int:
        """Drain migrations completed (registry view)."""
        return int(self._c_migrated.value)

    @property
    def handoff_bytes(self) -> int:
        """Host-side KV bytes moved by migrate() (registry view)."""
        return int(self._c_handoff_bytes.value)

    @property
    def handoff_bytes_saved(self) -> int:
        """Head bytes NOT shipped thanks to prefix reuse (registry view)."""
        return int(self._c_handoff_saved.value)

    @property
    def n_tail_handoffs(self) -> int:
        """Migrations that shipped a partial tail (registry view)."""
        return int(self._c_tail_handoffs.value)

    @classmethod
    def build(cls, cfg, params, n_replicas: Optional[int] = None, *,
              default_ttft_slo: Optional[float] = None,
              overrides: Optional[Sequence[Optional[dict]]] = None,
              **engine_kwargs) -> "ReplicaPool":
        """Construct `n_replicas` engines over shared (read-only) params.
        `engine_kwargs` go to every BatchedServingEngine; `overrides` is an
        optional per-replica dict of engine kwargs layered on top — the
        disaggregation knobs (``role="prefill"|"decode"``, ``max_batch``,
        ``cache_capacity``, ``policy``, ``prefill_budget``, and a
        per-replica ``default_ttft_slo``) so prefill replicas can carry big
        residency pools / dense-traffic policies while decode replicas run
        small predictor-driven ones. With `overrides` given, `n_replicas`
        may be omitted (one replica per entry). A fresh RequestQueue/
        AdmissionController is built per replica (passing `queue=` here
        would alias one queue across replicas — rejected)."""
        if overrides is not None:
            n_replicas = len(overrides) if n_replicas is None else n_replicas
            if len(overrides) != n_replicas:
                raise ValueError(
                    "overrides must have one entry (or None) per replica")
        if n_replicas is None or n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas!r}")
        if "queue" in engine_kwargs:
            raise ValueError(
                "per-replica queues are built here; pass default_ttft_slo")
        _validate_engine_kwargs(engine_kwargs, "ReplicaPool.build(**engine_kwargs)")
        engines = []
        for r in range(n_replicas):
            kw = dict(engine_kwargs)
            if overrides is not None and overrides[r]:
                if "queue" in overrides[r]:
                    raise ValueError("per-replica queues are built here")
                _validate_engine_kwargs(overrides[r],
                                        f"ReplicaPool.build overrides[{r}]")
                kw.update(overrides[r])
            slo = kw.pop("default_ttft_slo", default_ttft_slo)
            q = (RequestQueue(AdmissionController(default_ttft_slo=slo))
                 if slo is not None else None)
            engines.append(BatchedServingEngine(cfg, params, queue=q, **kw))
        return cls(engines)

    @property
    def n(self) -> int:
        return len(self.engines)

    @property
    def disagg(self) -> bool:
        """True when any replica is phase-specialized (role != 'both') —
        the ClusterFrontend then runs the prefill->decode handoff loop."""
        return any(r != "both" for r in self.roles)

    def routable(self) -> List[int]:
        """Replica indices routers may send NEW requests to (everything
        not draining)."""
        return [i for i in range(self.n) if i not in self.draining]

    def role_indices(self, *roles: str) -> List[int]:
        return [i for i, r in enumerate(self.roles) if r in roles]

    def loads(self) -> List[ReplicaLoad]:
        return [e.load() for e in self.engines]

    def likely_keys(self) -> FrozenSet[ExpertKey]:
        """The likely-expert set a FRESH request is expected to activate
        (see likely_expert_keys). With empty-history predictor features /
        popularity priors this is a property of the shared model + workload
        — the same for every request — so it is computed once and cached
        for the pool's lifetime; affinity routing therefore ranks replicas
        by how much of this hot set each one holds RESIDENT right now (the
        per-replica term is live, the per-request term is not — making the
        set prompt-conditioned is an open ROADMAP item)."""
        if self._likely_cache is None:
            self._likely_cache = likely_expert_keys(self.engines[0])
        return self._likely_cache

    # -- snapshot migration (handoff + draining) -----------------------------
    def migrate(self, req: Request, src: int, dst: int) -> RequestHandle:
        """Move one live request from replica `src` to `dst` via the
        snapshot/restore primitive. The request's handle (if it was
        submitted through a frontend) is rebound to the restored request so
        the caller's event stream continues seamlessly — `.replica` and
        `.handoffs` record the hop. Raw engine submissions (no handle) get
        a fresh handle on the destination frontend.

        When the destination's prefix tree already holds the request's
        shared head (``prefix_head_for``), the snapshot is TAIL-ONLY: only
        the unique KV tail crosses host-side (``handoff_bytes`` grows by
        the tail alone; the head rows avoided are accounted in
        ``handoff_bytes_saved``) and restore rebuilds the head from the
        destination's own tree — bit-identical rows, deterministic
        prefill."""
        assert src != dst
        h = self.frontends[src]._handles.pop(req.rid, None)
        head = self.engines[dst].prefix_head_for(req)
        # flow-linked hop endpoints: the exporter pairs these two instants
        # (same flow id) into a Perfetto arrow from src track to dst track.
        # rid=None — both ends must record or neither (per-rid sampling
        # could otherwise keep one end and orphan the flow, since the
        # restored request gets a NEW engine-local rid)
        self._flow_seq += 1
        fid = self._flow_seq
        self.engines[src].obs.instant(
            "handoff.snapshot", lane="lifecycle", flow=fid,
            src=src, dst=dst, src_rid=req.rid)
        snap = self.engines[src].snapshot(req, kv_start=head)
        self._c_handoff_bytes.inc(snap.kv_bytes)
        if head:
            self._c_handoff_saved.inc(head * kv_row_bytes(
                self.engines[src]))
            self._c_tail_handoffs.inc()
        h = self.frontends[dst].resume(snap, handle=h, src=src, dst=dst)
        self.engines[dst].obs.instant(
            "handoff.restore", lane="lifecycle", flow=fid,
            src=src, dst=dst, dst_rid=h.rid, kv_bytes=snap.kv_bytes)
        h.replica = dst
        return h

    def _request_keys(self, req: Request) -> FrozenSet[ExpertKey]:
        """The (layer, expert) set THIS request's prefill actually
        activated — a per-request affinity signal (unlike the pool-wide
        ``likely_keys`` prior) for picking its decode replica."""
        return frozenset((l, int(e))
                         for l, acts in enumerate(req.prefill_active)
                         for e in acts)

    def _target_for(self, req: Request, state: str,
                    exclude: int) -> Optional[int]:
        """Best replica to move `req` (in lifecycle `state`) to, or None if
        no viable one exists right now: role-compatible (prefill work needs
        a prefill-capable replica, decode work a decode-capable one), not
        draining, KV capacity sufficient, and — except for still-queued
        requests — a free KV slot. Ranked by overlap between the request's
        own observed expert activations and the replica's live residency
        (fewest handoff refetches), then load, then index."""
        need = req.prompt_len + req.max_new + 1
        roles_ok = {"queued": ("prefill", "both"),
                    "prefilling": ("prefill", "both"),
                    "running": ("decode", "both"),
                    "held": ("decode", "both")}[state]
        cands = []
        for j in range(self.n):
            if j == exclude or j in self.draining:
                continue
            eng = self.engines[j]
            if self.roles[j] not in roles_ok or need > eng.W:
                continue
            if state == "prefilling" and not eng.chunked:
                continue
            if state != "queued" and not eng.slot_available:
                continue
            cands.append(j)
        if not cands:
            return None
        keys = self._request_keys(req)
        loads = self.loads()
        return max(cands,
                   key=lambda j: (self.engines[j].cache.residency_overlap(
                       keys), -loads[j].total_tokens, -j))

    def handoff_held(self) -> int:
        """One prefill->decode handoff pass (the ClusterFrontend runs this
        every poll on a disaggregated pool): every held request on a
        prefill-role replica whose KV fits a decode replica with a free
        slot migrates there and joins its decode batch; the rest stay held
        and retry next pass. Returns handoffs completed."""
        moved = 0
        for i in self.role_indices("prefill"):
            for req in list(self.engines[i].held):
                j = self._target_for(req, "held", exclude=i)
                if j is None:
                    continue
                self.migrate(req, i, j)
                self._c_handoffs.inc()
                moved += 1
        return moved

    # -- draining (elasticity primitive) -------------------------------------
    def drain(self, i: int) -> int:
        """Begin draining replica `i`: routers stop sending it NEW work
        (``routable()`` excludes it) and its in-flight requests migrate to
        other replicas via snapshot/restore — whatever fits a target NOW
        moves immediately (returned count); the rest keep stepping locally
        while the ClusterFrontend retries every poll, so a request that
        never finds a target simply completes where it is. Reversible via
        ``undrain``."""
        if not 0 <= i < self.n:
            raise ValueError(f"no replica {i} in a pool of {self.n}")
        self.draining.add(i)
        return self.migrate_draining()

    def undrain(self, i: int) -> None:
        """Return a draining replica to routable service (requests already
        migrated away stay where they landed)."""
        self.draining.discard(i)

    def migrate_draining(self) -> int:
        """One migration pass over every draining replica's live requests
        (queued first — they need no target slot — then held, prefilling,
        running). Returns migrations completed."""
        moved = 0
        for i in sorted(self.draining):
            eng = self.engines[i]
            groups = (("queued", list(eng.queue.pending)),
                      ("held", list(eng.held)),
                      ("prefilling", list(eng.prefilling)),
                      ("running", list(eng.running)))
            for state, reqs in groups:
                for req in reqs:
                    j = self._target_for(req, state, exclude=i)
                    if j is None:
                        continue
                    self.migrate(req, i, j)
                    self._c_migrated.inc()
                    moved += 1
        return moved

    # -- observability -------------------------------------------------------
    def recorders(self) -> List:
        """Per-replica span recorders in replica order — the input
        ``repro_torch.obs.chrome_trace`` exporters take."""
        return [e.obs for e in self.engines]

    def metrics_snapshot(self) -> dict:
        """JSON-ready nested snapshot: pool-level handoff/migration
        counters plus one registry snapshot per replica engine. Valid
        under ``validate_metrics_snapshot`` (schema repro.obs.metrics/1)."""
        return {"schema": METRICS_SCHEMA,
                "cluster": self.metrics.snapshot(),
                "replicas": [e.metrics.snapshot() for e in self.engines]}


class ClusterFrontend(CooperativeDriver):
    """The ``ServingFrontend`` surface over a ReplicaPool: ``submit(spec) ->
    RequestHandle``, cooperative ``poll()`` stepping every replica once (in
    replica order — deterministic), ``cancel(handle)`` delegating to the
    owning replica. Handles submitted here drive the CLUSTER poll when
    iterated, so waiting on one request keeps all replicas advancing.

    Router rejections (slo_headroom finding no capable replica) produce a
    terminal handle carrying a ``RejectEvent("router_slo")`` — the request
    never occupies any replica's queue; ``n_router_rejected`` counts them
    for the pool's lifetime (``router_rejected`` retains a bounded window
    of the Request records) and their negative rids keep them disjoint
    from every replica-local rid space (replica rids start at 0 per
    engine, so cluster-level event streams disambiguate requests by
    HANDLE, not rid). Terminal handles are NOT retained here — the
    per-replica dispatch tables reap them, so a long-running cluster's
    memory stays bounded.
    """

    def __init__(self, pool: ReplicaPool,
                 router: Union[str, Router] = "least_loaded",
                 rejected_window: Optional[int] = 512):
        self.pool = pool
        self.router = make_router(router)
        self.router_rejected: Deque[Request] = collections.deque(
            maxlen=rejected_window)
        self.n_router_rejected = 0
        self.autopilot = None   # QosAutopilot registers itself here

    # -- submission ----------------------------------------------------------
    def submit(self, spec, **kw) -> RequestHandle:
        """Route a GenerationRequest (or raw prompt + fields, as with
        ServingFrontend.submit) to a replica and submit it there. The
        returned handle polls the CLUSTER; its ``.replica`` records the
        owning replica index (None for router rejections)."""
        spec = as_request_spec(spec, **kw)
        now = time.perf_counter()
        if spec.arrival is None:
            # stamp once so router scoring and the engine record agree
            spec = dataclasses.replace(spec, arrival=now)
        choice = self.router.choose(spec, self.pool, now)
        if choice is None:
            return self._reject(spec, now)
        handle = self.pool.frontends[choice].submit(spec)
        handle._fe = self              # iteration drives the cluster poll
        handle.replica = choice
        return handle

    def _reject(self, spec: GenerationRequest, now: float) -> RequestHandle:
        # negative rids keep router rejections disjoint from every
        # replica-local rid space
        self.n_router_rejected += 1
        req = Request(rid=-self.n_router_rejected,
                      prompt=np.asarray(spec.prompt, np.int32).reshape(-1),
                      params=spec.params, arrival=spec.arrival,
                      ttft_slo=spec.ttft_slo, tbt_slo=spec.tbt_slo,
                      priority=spec.priority, state="rejected")
        self.router_rejected.append(req)
        handle = RequestHandle(self, req)
        handle._on_event(RejectEvent(rid=req.rid, reason="router_slo",
                                     t=now))
        return handle

    # -- cooperative driving -------------------------------------------------
    @property
    def idle(self) -> bool:
        # autopilot-paused requests keep the cluster non-idle: a later
        # poll's scan resumes them once headroom returns
        return all(fe.idle for fe in self.pool.frontends) and not (
            self.autopilot is not None and self.autopilot.paused)

    def poll(self, now: Optional[float] = None) -> StepEvents:
        """One cluster iteration: step every replica once (replica order),
        run the pool's KV-migration passes — the prefill->decode handoff
        on a disaggregated pool, and retry migration off draining replicas
        — then the autopilot's shed/preempt scan (shed
        FinishEvents("slo_shed") are appended to the returned stream).
        NOTE: merged events carry replica-LOCAL rids; consumers that track
        individual requests should hold their handles."""
        events: List = []
        did_work = False
        for fe in self.pool.frontends:
            ev = fe.poll(now)
            events.extend(ev)
            did_work |= ev.did_work
        if self.pool.disagg:
            did_work |= bool(self.pool.handoff_held())
        if self.pool.draining:
            did_work |= bool(self.pool.migrate_draining())
        if self.autopilot is not None:
            self.autopilot.scan_into(now, events)
        return StepEvents(events, did_work)

    # -- delegation ----------------------------------------------------------
    def cancel(self, handle: RequestHandle,
               reason: str = "cancelled") -> bool:
        if handle.done:
            return False
        if handle.req.state == "paused":
            return self._cancel_paused(handle, reason)
        if handle.replica is None:
            return False
        return self.pool.frontends[handle.replica].cancel(handle,
                                                          reason=reason)

    def live_handles(self) -> List[RequestHandle]:
        out: List[RequestHandle] = []
        for fe in self.pool.frontends:
            out.extend(fe.live_handles())
        return out

    def engine_of(self, handle: RequestHandle) -> BatchedServingEngine:
        assert handle.replica is not None, "router-rejected handle"
        return self.pool.engines[handle.replica]


class QosAutopilot:
    """Per-poll SLO shed policy:
    sheds requests whose deadline is ALREADY unmeetable mid-flight, so a
    doomed request stops burning KV slots / prefill budget / expert
    residency that surviving requests could meet their SLOs with.

    Attaches to a ClusterFrontend or a plain ServingFrontend (it registers
    as ``frontend.autopilot``; both run ``scan`` after each poll's event
    dispatch and append shed FinishEvents to the poll's returned stream).
    Two triggers, both against the owning replica's live admission
    predictor (the SAME ``AdmissionController.predict_ttft`` that gated
    the request at admission):

      * TTFT — no first token yet, and even an IMMEDIATE start (zero
        backlog ahead: time already waited + own remaining work + decode
        interference) would overrun ``ttft_slo + grace`` — the admission
        REJECT boundary, so requests admission parked in its QUEUE band
        ("reachable once the backlog drains") are NOT shed early.
      * TBT — first token emitted, and the NEXT token's deadline
        (last token time + tbt_slo + grace) has already passed.

    Shedding goes through ``handle.cancel(reason="slo_shed")`` — the same
    synchronous reclamation as a caller cancel — surfaced as
    ``FinishEvent(reason="slo_shed")`` and counted here (``n_shed``,
    ``by_reason``; ``shed`` retains a bounded window of handles) and on
    the owning engine (``n_slo_shed``). Requests without SLOs are never
    touched; survivors stay bit-exact.

    Preemption (``preempt=True``) adds a second, RECOVERABLE action on top
    of shedding: when a strictly-higher-priority request is stuck queued
    behind a full slot pool, the lowest-priority (youngest-first) running
    or prefilling request is PAUSED host-side via the snapshot primitive
    (``ServingFrontend.pause`` — KV slot, residency contributions, and TBT
    entry released exactly like a cancel, but no FinishEvent: the request
    is parked, not killed) and resumed — bit-exactly, possibly on a
    different replica — once headroom returns (a free slot and no
    higher-priority work still waiting there). Paused requests are
    excluded from every load/headroom signal (they hold no engine
    resources); their KV lives host-side in the parked snapshots
    (``paused_kv_bytes`` — what memory accounting should charge) and the
    pause interval is never billed as an inter-token gap
    (``TBTLedger.reopen``)."""

    def __init__(self, frontend, *, grace: float = 0.0,
                 shed_window: Optional[int] = 512,
                 preempt: bool = False):
        self.fe = frontend
        self.grace = grace
        self.preempt = preempt
        self.shed: Deque[RequestHandle] = collections.deque(
            maxlen=shed_window)
        # counters live on the pool registry (cluster front-end) or the
        # engine's own (plain ServingFrontend); n_shed / by_reason /
        # n_preempted / n_resumed below are read-only registry views
        pool = getattr(frontend, "pool", None)
        reg = pool.metrics if pool is not None else frontend.engine.metrics
        self._c_shed = {r: reg.counter(
            "autopilot_shed_total", "requests shed mid-flight, by trigger",
            reason=r) for r in ("ttft", "tbt")}
        self._c_preempted = reg.counter(
            "autopilot_preempted_total",
            "requests paused host-side by priority preemption")
        self._c_resumed = reg.counter(
            "autopilot_resumed_total",
            "preempted requests resumed after headroom returned")
        reg.gauge("autopilot_paused_kv_bytes",
                  "host KV bytes held by currently-paused requests",
                  fn=lambda: self.paused_kv_bytes)
        # (handle, snapshot) pairs parked by preemption, resumed by scan
        self.paused: List[Tuple[RequestHandle, "RequestSnapshot"]] = []
        frontend.autopilot = self

    @property
    def paused_kv_bytes(self) -> int:
        """Host bytes of KV held by currently-paused requests."""
        return sum(s.kv_bytes for _, s in self.paused)

    # legacy counter attributes — thin read-only registry views
    @property
    def n_shed(self) -> int:
        """Total requests shed (registry view over both triggers)."""
        return int(sum(c.value for c in self._c_shed.values()))

    @property
    def by_reason(self) -> Dict[str, int]:
        """Shed counts by trigger (fresh dict; registry view)."""
        return {r: int(c.value) for r, c in self._c_shed.items()}

    @property
    def n_preempted(self) -> int:
        return int(self._c_preempted.value)

    @property
    def n_resumed(self) -> int:
        return int(self._c_resumed.value)

    def scan_into(self, now: Optional[float],
                  events: List) -> List[RequestHandle]:
        """scan(), then append each shed request's FinishEvent("slo_shed")
        to `events` — the one hook both front-ends' poll() call, so the
        returned event stream surfaces sheds identically everywhere."""
        shed_now = self.scan(now)
        for h in shed_now:
            events.append(h.events[-1])
        return shed_now

    def scan(self, now: Optional[float] = None) -> List[RequestHandle]:
        """One shed pass over the live handles (then, with ``preempt=True``,
        one resume-or-preempt pass); returns the handles shed by THIS pass.
        Called automatically after each poll once attached."""
        now = time.perf_counter() if now is None else now
        shed_now: List[RequestHandle] = []
        for h in self.fe.live_handles():
            if h.done:
                continue
            trigger = self._verdict(h, now)
            if trigger is None:
                continue
            if h.cancel(reason="slo_shed"):
                self.shed.append(h)
                self._c_shed[trigger].inc()
                # annotate the shed on the owning engine's timeline with
                # WHICH SLO trigger fired (the terminal span itself is
                # recorded by engine.cancel)
                h._fe.engine_of(h).obs.instant(
                    "autopilot.shed", lane="lifecycle", rid=h.rid,
                    trigger=trigger)
                shed_now.append(h)
        if self.preempt:
            self._scan_preempt()
        return shed_now

    # -- preemption (snapshot/restore consumer #2) ---------------------------
    def _frontends(self) -> List[ServingFrontend]:
        pool = getattr(self.fe, "pool", None)
        return list(pool.frontends) if pool is not None else [self.fe]

    def _scan_preempt(self) -> None:
        """Resume parked requests whose headroom returned, then pause a
        low-priority victim wherever a strictly-higher-priority request is
        stuck queued behind a FULL slot pool. Victim order: lowest
        priority first, youngest (largest rid) among equals — the least
        sunk work is parked. Only requests submitted through a frontend
        (i.e. with a handle) are preempted."""
        for item in list(self.paused):
            h, snap = item
            target = self._resume_target(snap)
            if target is None:
                continue
            fe, j = target
            fe.resume(snap, handle=h, dst=j)
            if j is not None:
                h.replica = j
            self.paused.remove(item)
            self._c_resumed.inc()
        for fe in self._frontends():
            eng = fe.engine
            if eng.slot_available or not len(eng.queue):
                continue   # a free slot exists / nothing is waiting
            top = max(r.priority for r in eng.queue.pending)
            viable = [r for r in eng.running + eng.prefilling
                      if r.priority < top and r.rid in fe._handles]
            if not viable:
                continue
            victim = min(viable, key=lambda r: (r.priority, -r.rid))
            h = fe._handles[victim.rid]
            # annotate WHY the pause happened (the request.paused instant
            # itself comes from engine.snapshot inside fe.pause)
            eng.obs.instant("autopilot.preempt", lane="lifecycle",
                            rid=victim.rid, priority=victim.priority,
                            top_priority=top)
            snap = fe.pause(h)
            self.paused.append((h, snap))
            self._c_preempted.inc()

    def _resume_target(self, snap: RequestSnapshot
                       ) -> Optional[Tuple[ServingFrontend, Optional[int]]]:
        """Where `snap` can resume NOW, or None: the engine must be able to
        restore it (free slot, KV capacity, chunked if mid-prefill) and
        must have no strictly-higher-priority request still queued (resume
        must not steal the slot the preemption freed). On a disaggregated
        pool the resume respects roles; ranked by the request's own
        expert-affinity, then load."""
        def ok(eng) -> bool:
            return eng.can_restore(snap) and not any(
                r.priority > snap.spec.priority for r in eng.queue.pending)

        pool = getattr(self.fe, "pool", None)
        if pool is None:
            return (self.fe, None) if ok(self.fe.engine) else None
        roles_ok = (("prefill", "both")
                    if snap.state in ("queued", "prefilling")
                    else ("decode", "both"))
        keys = frozenset((l, int(e))
                         for l, acts in enumerate(snap.prefill_active)
                         for e in acts)
        loads = pool.loads()
        best = None
        for j in pool.routable():
            if pool.roles[j] not in roles_ok or not ok(pool.engines[j]):
                continue
            score = (pool.engines[j].cache.residency_overlap(keys),
                     -loads[j].total_tokens, -j)
            if best is None or score > best[0]:
                best = (score, j)
        return (pool.frontends[best[1]], best[1]) if best else None

    def _verdict(self, h: RequestHandle, now: float) -> Optional[str]:
        req = h.req
        if not h.tokens:
            if req.ttft_slo is None:
                return None
            # resolve the owning engine through the handle's OWN frontend:
            # cluster-submitted handles carry a replica index, handles
            # submitted directly through a per-replica frontend (warm-up
            # traffic) resolve via that frontend — and the engine is only
            # needed at all on this SLO-carrying branch
            eng = h._fe.engine_of(h)
            # mirror the admission REJECT boundary exactly: shed only when
            # even an IMMEDIATE start (zero backlog ahead) would breach the
            # deadline — time already waited + the request's own remaining
            # work + decode interference. Charging the live backlog here
            # would shed every request admission deliberately parked in its
            # QUEUE band ("deadline still reachable once the backlog
            # drains"), turning that band into dead behavior.
            own = (req.prefill_remaining if req.state == "prefilling"
                   else req.prompt_len)
            predicted = eng.queue.admission.predict_ttft(
                now, req.arrival, own, 0,
                running_batch=len(eng.running),
                chunk_budget=eng._current_budget())
            return ("ttft" if predicted > req.ttft_slo + self.grace
                    else None)
        if req.tbt_slo is not None and h.last_token_t is not None:
            # the next token's deadline has passed and it hasn't arrived
            if now - h.last_token_t > req.tbt_slo + self.grace:
                return "tbt"
        return None
