"""Phase-specialized expert scheduling policies (paper §V + baselines §VI-A).

Four policies, each driving ONE CacheState so hit/miss/eviction/peak-memory
behaviour is identical between the live serving engine and the discrete-event
simulator. The engine passes its `ExpertResidency` (core/cache.py) as the
shared `state` — scheduler and device buffers then share a single ledger by
reference, every plan-time admit/evict/unpin landing symmetrically on device
memory; the simulator omits `state` and gets a plain ledger-only CacheState:

  * ODF  — On-Demand Fetch (HF-Accelerate-style): fetch activated experts
           only after gate selection, serial on the critical path.
  * LFP  — Layer-wise Full Prefetch (MoESys-style): prefetch every expert of
           the next layer; fast but peak-memory heavy.
  * MIF  — MoE-Infinity-style: big activation-aware LRU cache, trace-prior
           (popularity) prefetch of likely experts for upcoming layers.
  * DUO  — DuoServe-MoE: prefill = pipelined per-expert streaming (two
           streams, cache of k slots); decode = ExpertMLP-predicted prefetch
           one layer ahead + synchronous correction on miss.

`prefill_plan` / `decode_plan` mutate the policy's cache state and return
declarative plans the engine executes and the simulator times.

Decode plans accept multi-request selections (paper §V generalized to B>1):
`decode_plan(layer, selections)` takes either one request's [k] expert ids or
a sequence of per-request id lists; nested selections are unioned in
first-appearance order before cache bookkeeping, so the shared ExpertResidency
under continuous batching fetches each distinct expert once per step and the
hit/miss ledger counts distinct experts, not per-request duplicates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.cache import CacheState
from repro_torch.core.tracer import TraceStats


@dataclasses.dataclass
class PrefillPlan:
    layer: int
    order: List[int]          # expert execution order (active experts)
    fetches: List[int]        # subset of `order` that must be transferred
    overlap_first: bool       # first fetch may overlap non-MoE compute
    pipelined: bool           # fetch e+1 overlaps compute of e
    prefetch_all_first: bool  # all fetches complete before first compute


@dataclasses.dataclass
class DecodePlan:
    layer: int
    hits: List[int]           # selected experts already resident
    misses: List[int]         # selected experts needing a blocking fetch
    prefetch_next: List[int]  # experts to prefetch for layer+1 (async)
    predicted: List[int]      # what the policy predicted for THIS layer


def union_selection(selected) -> List[int]:
    """Flatten one request's [k] ids or B requests' [[k], ...] into a
    duplicate-free list, preserving first-appearance order (request 0's
    top-1 first). Order stability keeps fetch schedules deterministic."""
    seen: Set[int] = set()
    out: List[int] = []
    stack = list(selected)[::-1]
    while stack:
        e = stack.pop()
        if isinstance(e, (list, tuple, np.ndarray)):
            stack.extend(list(e)[::-1])
            continue
        e = int(e)
        if e not in seen:
            seen.add(e)
            out.append(e)
    return out


def default_capacity(name: str, n_layers: int, n_experts: int, top_k: int,
                     batch: int = 1) -> int:
    """Policy-default residency capacity (single source of truth; the engine
    uses it to size the ExpertResidency slot pool BEFORE constructing the
    scheduler that will share it).

    batch: max concurrent decode requests the cache must absorb per step."""
    name = name.lower()
    if name == "odf":
        return 2 * top_k * batch
    if name == "lfp":
        # staging is per-layer (all E experts), independent of batch size
        return 2 * n_experts
    if name == "mif":
        # MoE-Infinity holds a large activation-aware cache (Table II shows
        # its footprint is by far the largest of the compared systems)
        return max(4 * top_k * batch, int(0.6 * n_layers * n_experts))
    if name in ("duo", "duoserve"):
        # must cover one batched step's churn: the selected union
        # (<= batch*k) plus the widened next-layer prefetch (<= batch*k)
        return 2 * top_k * batch
    if name in ("duo+", "duo_plus"):
        # Beyond-paper variant (EXPERIMENTS.md §Perf): same dual-phase
        # scheduling, but the decode cache retains hot experts across steps.
        # Capacity must exceed one step's churn (selected + mispredicted
        # prefetches across all layers, ~1.5*L*k) or LRU evicts everything
        # before reuse; at that size temporal locality turns repeats into
        # zero-byte hits (measured: misses -5.4x, prefetch transfers -11x on
        # Mixtral) at ~half of MIF's footprint.
        return max(2 * top_k * batch,
                   3 * n_layers * top_k // 2 + 2 * top_k * batch)
    raise KeyError(name)


class BaseScheduler:
    name = "base"
    uses_predictor = False

    def __init__(self, n_layers: int, n_experts: int, top_k: int,
                 bytes_per_expert: int, capacity: int,
                 state: Optional[CacheState] = None):
        self.L = n_layers
        self.E = n_experts
        self.k = top_k
        if state is not None:
            # shared-ledger mode: the engine's ExpertResidency IS the cache;
            # grow it if this policy needs more room than it was built with
            if capacity > state.capacity:
                state.rescale(capacity)
            self.cache = state
        else:
            self.cache = CacheState(capacity, bytes_per_expert)
        self._next_prefetched: Dict[int, List[int]] = {}
        self.decode_hits = 0
        self.decode_misses = 0

    # -- shared helpers ----------------------------------------------------
    def begin_request(self) -> None:
        self._next_prefetched.clear()
        self.cache.unpin_all()

    def _fetch_missing(self, layer: int, experts: Sequence[int],
                       pinned: bool = True) -> List[int]:
        fetches = []
        for e in experts:
            key = (layer, int(e))
            if not self.cache.lookup(key):
                self.cache.admit(key, pinned=pinned)
                # an unpinned (speculative) admit into an all-pinned full
                # cache is declined — then there is nothing to transfer
                if self.cache.contains(key):
                    fetches.append(int(e))
        return fetches

    def _split_hits(self, layer: int, experts: Sequence[int]
                    ) -> Tuple[List[int], List[int]]:
        hits, misses = [], []
        for e in experts:
            key = (layer, int(e))
            if self.cache.lookup(key):
                hits.append(int(e))
            else:
                self.cache.admit(key)
                misses.append(int(e))
        self.decode_hits += len(hits)
        self.decode_misses += len(misses)
        return hits, misses

    @property
    def decode_hit_rate(self) -> float:
        tot = self.decode_hits + self.decode_misses
        return self.decode_hits / tot if tot else 0.0

    def end_layer(self, layer: int) -> None:
        """Unpin this layer's experts once its computation is done."""
        for key in list(self.cache.resident):
            if key[0] == layer:
                self.cache.unpin(key)

    # -- to override --------------------------------------------------------
    def prefill_plan(self, layer: int, active: Sequence[int]) -> PrefillPlan:
        raise NotImplementedError

    def decode_plan(self, layer: int, selected: Sequence[int],
                    features: Optional[np.ndarray] = None) -> DecodePlan:
        raise NotImplementedError


class ODFScheduler(BaseScheduler):
    """On-Demand Fetch (HF Accelerate semantics): offloaded module weights
    are loaded when the module runs and FREED after it — no cross-step reuse
    (`stateless=True`, the faithful baseline). Transfers sit on the critical
    path after the gate."""
    name = "odf"

    def __init__(self, n_layers, n_experts, top_k, bytes_per_expert,
                 capacity: Optional[int] = None, stateless: bool = True,
                 batch: int = 1, state=None):
        super().__init__(n_layers, n_experts, top_k, bytes_per_expert,
                         capacity or default_capacity(
                             "odf", n_layers, n_experts, top_k, batch),
                         state=state)
        self.stateless = stateless

    def prefill_plan(self, layer, active):
        fetches = self._fetch_missing(layer, active)
        return PrefillPlan(layer, list(map(int, active)), fetches,
                           overlap_first=False, pipelined=False,
                           prefetch_all_first=False)

    def decode_plan(self, layer, selected, features=None):
        selected = union_selection(selected)
        if self.stateless:
            # accelerate frees offloaded weights after each module forward;
            # drop() routes the free through the residency hooks so the
            # device slot is released too (no event: not a capacity evict)
            for key in [k for k in self.cache.resident if k[0] != layer]:
                self.cache.drop(key)
        hits, misses = self._split_hits(layer, selected)
        self.end_layer(layer)
        return DecodePlan(layer, hits, misses, prefetch_next=[], predicted=[])


class LFPScheduler(BaseScheduler):
    """Layer-wise Full Prefetch: all E experts of a layer are staged before
    expert computation; the next layer's experts prefetch during compute."""
    name = "lfp"

    def __init__(self, n_layers, n_experts, top_k, bytes_per_expert,
                 capacity: Optional[int] = None, batch: int = 1, state=None):
        super().__init__(n_layers, n_experts, top_k, bytes_per_expert,
                         capacity or default_capacity(
                             "lfp", n_layers, n_experts, top_k, batch),
                         state=state)

    def prefill_plan(self, layer, active):
        fetches = self._fetch_missing(layer, range(self.E))
        return PrefillPlan(layer, list(map(int, active)), fetches,
                           overlap_first=True, pipelined=False,
                           prefetch_all_first=True)

    def decode_plan(self, layer, selected, features=None):
        selected = union_selection(selected)
        hits, misses = self._split_hits(layer, selected)
        nxt = list(range(self.E)) if layer + 1 < self.L else []
        if nxt:
            self.end_layer(layer)  # free this layer before staging the next
            self._fetch_missing(layer + 1, nxt)
        return DecodePlan(layer, hits, misses, prefetch_next=nxt, predicted=[])


class MIFScheduler(BaseScheduler):
    """MoE-Infinity-style: large LRU cache + trace-prior (popularity)
    prefetch. Needs TraceStats; its 'prediction' for a layer is the top-k most
    popular experts (request-level tracing prior)."""
    name = "mif"
    uses_predictor = False

    def __init__(self, n_layers, n_experts, top_k, bytes_per_expert,
                 stats: TraceStats, capacity: Optional[int] = None,
                 batch: int = 1, state=None):
        cap = capacity or default_capacity("mif", n_layers, n_experts,
                                           top_k, batch)
        super().__init__(n_layers, n_experts, top_k, bytes_per_expert, cap,
                         state=state)
        self.stats = stats

    def _prior(self, layer: int) -> List[int]:
        return list(np.argsort(-self.stats.popularity[layer])[: self.k])

    def prefill_plan(self, layer, active):
        # prefetch trace-prior first, then whatever the gate actually needs
        prior = self._prior(layer)
        fetches = self._fetch_missing(layer, prior)
        fetches += self._fetch_missing(layer, active)
        act = set(map(int, active))
        order = ([e for e in prior if e in act]
                 + [e for e in map(int, active) if e not in prior])
        return PrefillPlan(layer, order, fetches, overlap_first=True,
                           pipelined=False, prefetch_all_first=True)

    def decode_plan(self, layer, selected, features=None):
        selected = union_selection(selected)
        predicted = self._prior(layer)
        hits, misses = self._split_hits(layer, selected)
        self.end_layer(layer)
        nxt = []
        if layer + 1 < self.L:
            nxt = [e for e in self._prior(layer + 1)
                   if not self.cache.contains((layer + 1, e))]
            # keep only what was actually admitted (speculative admits are
            # declined when the cache is full of pinned entries)
            nxt = self._fetch_missing(layer + 1, nxt, pinned=False)
        return DecodePlan(layer, hits, misses, prefetch_next=nxt,
                          predicted=predicted)


class DuoServeScheduler(BaseScheduler):
    """DuoServe-MoE.

    Prefill: two-stream pipeline — cache of k slots; expert e+1 streams in
    while e computes; the first fetch overlaps non-MoE compute.
    Decode: the ExpertMLP (trained offline) predicts layer l+1's experts
    during layer l's expert computation; predicted experts prefetch on the
    communication stream; gate-time mismatches trigger a blocking correction
    fetch (sync point #1 in the paper).
    """
    name = "duo"
    uses_predictor = True

    def __init__(self, n_layers, n_experts, top_k, bytes_per_expert,
                 predictor=None, state_constructor=None,
                 capacity: Optional[int] = None, batch: int = 1, state=None):
        super().__init__(n_layers, n_experts, top_k, bytes_per_expert,
                         capacity or default_capacity(
                             "duo", n_layers, n_experts, top_k, batch),
                         state=state)
        self.predictor = predictor
        self.state_constructor = state_constructor
        self._path: List[np.ndarray] = []

    def begin_request(self):
        super().begin_request()
        self._path = []

    def begin_decode_step(self):
        self._path = []
        self._next_prefetched.clear()

    def prefill_plan(self, layer, active):
        fetches = self._fetch_missing(layer, active)
        return PrefillPlan(layer, list(map(int, active)), fetches,
                           overlap_first=True, pipelined=True,
                           prefetch_all_first=False)

    def _predict(self, layer: int, width: Optional[int] = None) -> List[int]:
        if self.predictor is None or self.state_constructor is None:
            return []
        width = min(self.E, width or self.k)
        feat = self.state_constructor.features(self._path, layer)
        top = self.predictor.predict_topk(feat[None], k=width)[0]
        return [int(e) for e in top[:width]]

    def decode_plan(self, layer, selected, features=None):
        # a batched step needs up to n_req*k distinct experts at layer l+1;
        # widen the prediction stream accordingly (single request: k).
        n_req = sum(1 for s in selected
                    if isinstance(s, (list, tuple, np.ndarray))) or 1
        selected = union_selection(selected)
        predicted = self._next_prefetched.get(layer, [])
        hits, misses = self._split_hits(layer, selected)
        self._path.append(np.asarray(selected, np.int32))
        nxt = []
        if layer + 1 < self.L:
            nxt = self._predict(layer + 1, width=n_req * self.k)
            self.end_layer(layer)
            nxt = self._fetch_missing(layer + 1, nxt)
            self._next_prefetched[layer + 1] = nxt
        return DecodePlan(layer, hits, misses, prefetch_next=nxt,
                          predicted=predicted)


def make_scheduler(name: str, n_layers: int, n_experts: int, top_k: int,
                   bytes_per_expert: int, *, stats: Optional[TraceStats] = None,
                   predictor=None, state_constructor=None,
                   capacity: Optional[int] = None,
                   batch: int = 1, state: Optional[CacheState] = None
                   ) -> BaseScheduler:
    """batch: max concurrent decode requests the cache must absorb per
    step (continuous batching); scales the policy default capacities.
    state: a shared CacheState/ExpertResidency to drive instead of
    constructing a private ledger — the engine passes its residency here so
    exactly ONE ledger exists per engine; the simulator omits it."""
    name = name.lower()
    if name == "odf":
        return ODFScheduler(n_layers, n_experts, top_k, bytes_per_expert,
                            capacity, batch=batch, state=state)
    if name == "lfp":
        return LFPScheduler(n_layers, n_experts, top_k, bytes_per_expert,
                            capacity, batch=batch, state=state)
    if name == "mif":
        assert stats is not None, "MIF needs TraceStats"
        return MIFScheduler(n_layers, n_experts, top_k, bytes_per_expert,
                            stats, capacity, batch=batch, state=state)
    if name in ("duo", "duoserve"):
        return DuoServeScheduler(n_layers, n_experts, top_k, bytes_per_expert,
                                 predictor, state_constructor, capacity,
                                 batch=batch, state=state)
    if name in ("duo+", "duo_plus"):
        # see default_capacity("duo+"): cross-step retention variant
        return DuoServeScheduler(n_layers, n_experts, top_k, bytes_per_expert,
                                 predictor, state_constructor,
                                 capacity or default_capacity(
                                     "duo+", n_layers, n_experts, top_k,
                                     batch),
                                 state=state)
    raise KeyError(name)
