"""Continuous-batching serving engine on PyTorch (port of
``repro.serving.batching``).

Requests are admitted mid-flight into a slot pool of per-layer
``[max_batch, W, Hkv, hd]`` K/V tensors on the engine's device (one slot per
in-flight request, ring invariant slot == pos % W, the per-slot positions
``_slot_pos`` kept on the host). Each ``step()`` admits arrivals through the
SLO-aware ``RequestQueue``, spends at most ``prefill_budget`` prompt tokens
of chunked prefill (``EngineCore.prefill_chunk``; ``None`` prefills each
admitted request whole), then runs ONE batched decode step for every
in-flight request. Per step and layer, the B rows' expert selections are
unioned (first-appearance order) and handed to the one scheduler /
``ExpertResidency`` pair, so each distinct expert is fetched at most once
per step for all rows. Cancellation, snapshot / restore, prefix reuse,
roles and the event stream are the reference's, call for call.

On the card:

  * batched decode attention is ``flash_decode`` over the batch's pool
    rows: a view of the pool when the batch's slots are consecutive and in
    order, else a gather copy of those rows (the new K/V row is written
    back to the pool in place);
  * chunked-prefill attention is ``flash_decode`` with the chunk's queries
    folded into its batch (``layers.self_attn_prefill_chunk``), monolithic
    prefill ``flash_attention``;
  * the grouped decode sweep is one ``expert_ffn_from_pool`` launch per
    layer, reading the slabs by slot out of the residency pools.

Numerics, against the JAX package:

  * ``grouped_decode=True`` (default) takes the expert kernel's numbers
    (h rounded to bf16, f32 sums) on both devices, as the port's fused
    prefill does. The reference's grouped einsum is bit-equal to its dense
    path; its Pallas backend (``REPRO_OPT_GROUPED_FFN=1``) is not. So this
    path is held against the JAX engine under ``REPRO_OPT_GROUPED_FFN=1``,
    and its batch invariance as "a batch of B == each request alone
    through the same engine at ``max_batch=1``".
  * ``grouped_decode=False`` (the dense per-expert baseline) keeps the
    einsum's numbers, so it is held bit for bit against the single-request
    ``MoEServingEngine`` run request by request.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Set, Union

import numpy as np
import torch

from repro_torch.core.cache import ExpertKey
from repro_torch.core.prefix import PrefixTree
from repro_torch.core.qos import (Admission, AdmissionController, ReplicaLoad,
                                  TBTLedger)
from repro_torch.core.scheduler import DuoServeScheduler
from repro_torch.models.layers import PDT
from repro_torch.obs.spans import SpanRecorder, monotonic
from repro_torch.serving.api import (FinishEvent, GenerationRequest,
                                     RejectEvent, RequestSnapshot,
                                     SamplingParams, StepEvents, TokenEvent)
from repro_torch.serving.engine import (EngineCore, RequestResult,
                                        _logits_row, group_by_expert)


@dataclasses.dataclass
class Request:
    """One request's RUNTIME state inside the engine (the engine-internal
    counterpart of the immutable ``GenerationRequest`` spec)."""
    rid: int
    prompt: np.ndarray               # [S] int32
    params: SamplingParams
    arrival: float
    ttft_slo: Optional[float] = None
    tbt_slo: Optional[float] = None
    priority: int = 0
    # queued|prefilling|running|held|done|rejected|cancelled|paused
    state: str = "queued"
    finish_reason: Optional[str] = None  # length|stop_token|cancelled|slo_shed
    slot: int = -1
    prefill_pos: int = 0             # prompt tokens already prefilled
    prefix_len: int = 0              # leading tokens seeded from PrefixTree
    tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_active: List[List[int]] = dataclasses.field(default_factory=list)
    active_sets: Optional[List[set]] = None   # accumulating, chunked prefill
    trace: List[np.ndarray] = dataclasses.field(default_factory=list)
    pred: List[np.ndarray] = dataclasses.field(default_factory=list)
    hits: int = 0
    misses: int = 0
    t_start: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    rng: Optional[np.random.Generator] = None

    @property
    def max_new(self) -> int:
        return self.params.max_new_tokens

    @property
    def temperature(self) -> Optional[float]:
        return self.params.temperature   # None = engine default

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefill_pos

    @property
    def pos(self) -> int:
        """Absolute position of the NEXT token to decode."""
        return self.prompt_len + len(self.tokens) - 1

    @property
    def done(self) -> bool:
        return (self.finish_reason is not None
                or len(self.tokens) >= self.max_new + 1)

    def result(self) -> RequestResult:
        T = len(self.trace)
        L_k = self.trace[0].shape if T else (0, 0)
        return RequestResult(
            tokens=np.asarray(self.tokens, np.int64),
            prefill_active=self.prefill_active,
            decode_trace=(np.stack(self.trace) if T
                          else np.zeros((0,) + L_k, np.int32)),
            pred_trace=(np.stack(self.pred) if T
                        else np.zeros((0,) + L_k, np.int32)),
            # cancelled before the first token: no TTFT exists
            ttft_wall=(self.t_first - self.arrival if self.t_first
                       else float("nan")),
            e2e_wall=self.t_done - self.arrival,
            hits=self.hits, misses=self.misses,
            finish_reason=self.finish_reason or "length")


def kv_row_bytes(engine: "BatchedServingEngine") -> int:
    """Bytes one KV row (one position: K+V across all layers) occupies."""
    return int(2 * engine.L * engine.cfg.n_kv_heads * engine.cfg.hd
               * PDT.itemsize)


def _nan_to_zero(fn):
    """Wrap a pull-gauge callback so an empty sketch's NaN reads as 0.0."""
    def g() -> float:
        v = float(fn())
        return v if v == v else 0.0
    return g


def parse_prefill_budget(v: Union[int, str, None]) -> Union[int, str, None]:
    """CLI-string form of `prefill_budget`: int tokens, "auto", or
    None/"none" for monolithic."""
    if v is None or v == "none":
        return None
    if v == "auto":
        return "auto"
    return int(v)


class RequestQueue:
    """Arrival queue with SLO-aware admission (core/qos.py).

    `pop_admissible` hands back up to `limit` requests whose predicted TTFT
    fits their deadline; breached requests, and requests whose `tbt_slo` is
    structurally unmeetable, are shed (state='rejected'). Candidates are
    considered in (priority desc, arrival) order; the TTFT prediction folds
    in the admitted prefill backlog and the running batch's decode
    interference.
    """

    def __init__(self, admission: Optional[AdmissionController] = None):
        self.admission = admission or AdmissionController()
        self.pending: Deque[Request] = collections.deque()
        self.rejected: List[Request] = []

    def __len__(self) -> int:
        return len(self.pending)

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def remove(self, req: Request) -> bool:
        """Withdraw a still-queued request (cancellation before admission)."""
        try:
            self.pending.remove(req)
            return True
        except ValueError:
            return False

    def queued_tokens(self) -> int:
        return sum(r.prompt_len for r in self.pending)

    def pop_admissible(self, now: float, limit: int, *,
                       backlog_tokens: int = 0, running_batch: int = 0,
                       chunk_budget: Optional[int] = None,
                       chunk_adaptive: bool = False,
                       hit_fn=None) -> List[Request]:
        out: List[Request] = []
        ahead = backlog_tokens
        taken: List[Request] = []
        for req in sorted(self.pending, key=lambda r: -r.priority):
            if len(out) >= limit:
                break
            # prefix-cache-aware charging: only the un-hit suffix counts
            hit = hit_fn(req) if hit_fn is not None else 0
            verdict = self.admission.decide(
                now, req.arrival, req.prompt_len - hit, ahead, req.ttft_slo,
                running_batch=running_batch, chunk_budget=chunk_budget,
                tbt_slo=req.tbt_slo, chunk_adaptive=chunk_adaptive)
            if verdict is Admission.QUEUE:
                # deadline still reachable once the backlog drains: stop
                # admitting this round (no lower priority jumps past it)
                break
            taken.append(req)
            if verdict is Admission.REJECT:
                req.state = "rejected"
                self.rejected.append(req)
                continue
            ahead += req.prompt_len - hit
            out.append(req)
        for req in taken:
            self.pending.remove(req)
        return out


class BatchedServingEngine(EngineCore):
    """Continuous-batching engine: slot-pool KV + shared expert scheduling.

    max_batch: concurrent in-flight requests (= KV slots).
    max_seq: per-slot KV capacity W (prompt + generated tokens must fit).
    prefill_budget: max prompt tokens of prefill work per step() (chunked,
        state 'prefilling'); None = monolithic; "auto" = derived each step
        from the live LatencyModel (needs tbt_slo).
    prefill_fairness: "rr" (default) rotates the per-step budget across the
        prefilling requests, "srf" serves shortest-remaining-first, "fifo"
        head-of-line.
    prefix_cache: cross-request prefix/KV reuse over the slot pool
        (core/prefix.py).
    tbt_slo: engine-default inter-token-gap bound for the auto budget.
    finished_window: retain only the most recent N finished / cancelled
        requests (None = unbounded).
    role: "both", "prefill" (hold requests after prefill for a KV handoff)
        or "decode".
    grouped_decode: one grouped expert launch per layer (default) or the
        dense per-expert baseline (see the module docstring for numerics).

    ``step()`` returns a ``StepEvents`` list; ``run_until_drained()`` drives
    it and returns the finished-request records.
    """

    def __init__(self, cfg, params, policy: str = "duo", *,
                 max_batch: int = 4, max_seq: int = 128,
                 prefill_budget: Union[int, str, None] = None,
                 prefill_fairness: str = "rr",
                 tbt_slo: Optional[float] = None,
                 finished_window: Optional[int] = None,
                 tbt_window: Optional[int] = 8192,
                 queue: Optional[RequestQueue] = None,
                 role: str = "both",
                 prefix_cache: bool = False,
                 grouped_decode: bool = True,
                 fused_prefill: bool = True,
                 stats=None, predictor=None, cache_capacity=None,
                 temperature: float = 0.0, sample_seed: int = 0,
                 spans: Union[bool, SpanRecorder] = False):
        if prefill_budget == "auto":
            if tbt_slo is None or tbt_slo <= 0:
                raise ValueError('prefill_budget="auto" needs a tbt_slo target')
        elif prefill_budget is not None and prefill_budget < 1:
            raise ValueError("prefill_budget must be None, 'auto', or >= 1 token")
        if prefill_fairness not in ("rr", "fifo", "srf"):
            raise ValueError(f"bad prefill_fairness {prefill_fairness!r}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"bad role {role!r}")
        super().__init__(cfg, params, policy, stats=stats,
                         predictor=predictor, cache_capacity=cache_capacity,
                         temperature=temperature, sample_seed=sample_seed,
                         sched_batch=max_batch,
                         prefill_chunk=(prefill_budget
                                        if isinstance(prefill_budget, int)
                                        else None),
                         fused_prefill=fused_prefill, spans=spans)
        self.grouped_decode = grouped_decode
        self.decode_step_wall: List[float] = []
        self.max_batch = max_batch
        self.W = max_seq
        self.prefill_budget = prefill_budget
        self.prefill_fairness = prefill_fairness
        self.tbt_slo = tbt_slo
        self.queue = RequestQueue() if queue is None else queue
        self.sample_seed = sample_seed
        shape = (max_batch, max_seq, cfg.n_kv_heads, cfg.hd)
        self._K = [torch.zeros(shape, dtype=PDT, device=self.device)
                   for _ in range(self.L)]
        self._V = [torch.zeros_like(k) for k in self._K]
        self._slot_pos = np.full((max_batch, max_seq), -1, np.int32)
        self._free: List[int] = list(range(max_batch))[::-1]
        self.role = role
        self.prefilling: List[Request] = []   # state='prefilling'
        self.running: List[Request] = []
        self.held: List[Request] = []         # state='held' (role=prefill)
        self.finished: Deque[Request] = collections.deque(
            maxlen=finished_window)
        self.cancelled: Deque[Request] = collections.deque(
            maxlen=finished_window)
        self.tbt = TBTLedger(window=tbt_window)
        for q, sk in self.tbt.sketches.items():
            self.metrics.gauge(f"tbt_gap_seconds_p{int(q)}_stream",
                               "streaming P2 inter-token-gap percentile",
                               fn=_nan_to_zero(sk.value))
        self.metrics.gauge("tbt_gap_seconds_max",
                           "lifetime maximum inter-token gap",
                           fn=self.tbt.max_gap)
        self.metrics.gauge("tbt_gaps_total",
                           "inter-token gaps observed (lifetime)",
                           fn=lambda: self.tbt.total_gaps)
        self._h_step = self.metrics.histogram(
            "decode_step_seconds", "batched decode step wall time")
        self.prefix = PrefixTree() if prefix_cache else None
        self._c_prefilled = self.metrics.counter(
            "engine_prefilled_tokens_total",
            "prompt tokens run through prefill kernels")
        self._next_rid = 0
        self._pf_rr = 0   # round-robin rotation cursor across steps
        self.step_count = 0
        self.decode_batch_hist: List[int] = []

    @property
    def chunked(self) -> bool:
        return self.prefill_budget is not None

    @property
    def idle(self) -> bool:
        """No queued, prefilling, running, or held requests."""
        return not (self.running or self.prefilling or self.held
                    or len(self.queue))

    @property
    def prefilled_tokens(self) -> int:
        return int(self._c_prefilled.value)

    def _current_budget(self) -> Optional[int]:
        """This step's prefill token budget; auto mode asks the live cost
        model against the tightest in-flight TBT target."""
        if self.prefill_budget is None:
            return None
        if self.prefill_budget == "auto":
            slos = [r.tbt_slo for r in self.running + self.prefilling
                    if r.tbt_slo is not None]
            slos.append(self.tbt_slo)
            return self.queue.admission.model.suggest_chunk(min(slos))
        return self.prefill_budget

    # -- event sink ---------------------------------------------------------
    def _emit_token(self, req: Request, tok: int, t: float,
                    first: bool = False) -> None:
        """THE token sink for every generated token (and the stop-token
        early-termination point)."""
        req.tokens.append(tok)
        if first:
            req.t_first = t
        self.tbt.observe(req.rid, t)
        if req.finish_reason is None and req.params.stop_token_ids \
                and tok in req.params.stop_token_ids:
            req.finish_reason = "stop_token"
        self._emit(TokenEvent(rid=req.rid, token=tok,
                              index=len(req.tokens) - 1, t=t, first=first))

    # -- submission ---------------------------------------------------------
    def submit_request(self, spec: GenerationRequest) -> Request:
        """Submit a typed GenerationRequest; returns the runtime Request."""
        prompt = np.asarray(spec.prompt, np.int32).reshape(-1)
        req = Request(rid=self._next_rid, prompt=prompt, params=spec.params,
                      arrival=(time.perf_counter() if spec.arrival is None
                               else spec.arrival),
                      ttft_slo=spec.ttft_slo, tbt_slo=spec.tbt_slo,
                      priority=spec.priority)
        seed = (spec.params.seed if spec.params.seed is not None
                else self.sample_seed + req.rid)
        req.rng = np.random.default_rng(seed)
        need = req.prompt_len + spec.params.max_new_tokens + 1
        if need > self.W:
            raise ValueError(f"request needs {need} slots > W={self.W}")
        self._next_rid += 1
        self.queue.submit(req)
        self.obs.instant("request.queued", rid=req.rid,
                         prompt_len=req.prompt_len)
        return req

    def submit(self, prompt: np.ndarray,
               params: Optional[SamplingParams] = None, *,
               max_new: Optional[int] = None,
               arrival: Optional[float] = None,
               ttft_slo: Optional[float] = None,
               tbt_slo: Optional[float] = None,
               priority: int = 0,
               temperature: Optional[float] = None) -> Request:
        """Sugar over `submit_request`: legacy `max_new=` / `temperature=`
        are folded into a SamplingParams."""
        if params is None:
            params = SamplingParams(
                temperature=temperature,
                max_new_tokens=16 if max_new is None else max_new)
        elif max_new is not None or temperature is not None:
            raise ValueError("pass sampling via params OR legacy kwargs")
        return self.submit_request(GenerationRequest(
            prompt=np.asarray(prompt, np.int32).reshape(-1), params=params,
            ttft_slo=ttft_slo, tbt_slo=tbt_slo, priority=priority,
            arrival=arrival))

    # -- cancellation -------------------------------------------------------
    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel a request mid-flight (synchronous, idempotent): dequeue
        it, or remove it from its phase list, return its KV slot, drop the
        expert-residency entries no other in-flight request touched, close
        its TBT entry, and emit one final ``FinishEvent(reason)``. Returns
        False if it is already terminal or paused."""
        if req.state in ("done", "rejected", "cancelled", "paused"):
            return False
        if req.state == "queued":
            if not self.queue.remove(req):
                return False
        elif req.state in ("prefilling", "running", "held"):
            {"prefilling": self.prefilling, "running": self.running,
             "held": self.held}[req.state].remove(req)
            self._release_expert_contributions(req)
            self._release_slot(req)
        else:  # pragma: no cover - unknown state is a bug
            raise AssertionError(f"cancel from state {req.state!r}")
        req.state = "cancelled"
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        req.active_sets = None
        self.tbt.close(req.rid)
        self.cancelled.append(req)
        self.obs.terminal(req.rid, reason, n_tokens=len(req.tokens))
        self._emit(FinishEvent(rid=req.rid, reason=reason,
                               n_tokens=len(req.tokens), t=req.t_done))
        return True

    @property
    def n_slo_shed(self) -> int:
        return sum(1 for r in self.cancelled
                   if r.finish_reason == "slo_shed")

    # -- load introspection -------------------------------------------------
    def load(self) -> ReplicaLoad:
        """This engine's outstanding work as a ReplicaLoad (core/qos.py)."""
        dec = sum(r.max_new + 1 - len(r.tokens) for r in self.running)
        if self.role != "prefill":
            dec += sum(r.max_new + 1 for r in self.prefilling)
        return ReplicaLoad(
            queue_depth=len(self.queue),
            queued_tokens=self.queue.queued_tokens(),
            prefill_backlog=sum(r.prefill_remaining
                                for r in self.prefilling),
            running=len(self.running),
            decode_backlog=dec,
            free_slots=len(self._free) + (self.prefix.n_reclaimable()
                                          if self.prefix is not None else 0),
            held=len(self.held))

    @property
    def slot_available(self) -> bool:
        return bool(self._free) or (self.prefix is not None
                                    and self.prefix.n_reclaimable() > 0)

    def _acquire_slot(self) -> int:
        """Pop a free KV slot, evicting tree-owned prefixes (LRU) when the
        free list is empty."""
        if not self._free and self.prefix is not None:
            self._free.extend(self.prefix.evict_for(1))
        return self._free.pop()

    def _release_slot(self, req: Request) -> None:
        self._slot_pos[req.slot, :] = -1
        if self.prefix is not None and self.prefix.slot_released(req.slot):
            return   # the tree still references the rows: tree-owned cache
        self._free.append(req.slot)

    # -- cross-request prefix/KV reuse --------------------------------------
    def _prefix_peek(self, req: Request) -> int:
        """Read-only longest cached prefix usable by `req` (capped at
        prompt_len - 1: the last prompt position always prefills)."""
        if self.prefix is None or req.prompt_len < 2:
            return 0
        return self.prefix.peek(req.prompt, limit=req.prompt_len - 1)

    def _prefix_match(self, req: Request):
        """Acquire (pin) the longest cached prefix: (n_hit, row blocks)."""
        if self.prefix is None or req.prompt_len < 2:
            return 0, []
        n_hit, blocks = self.prefix.match(req.prompt,
                                          limit=req.prompt_len - 1)
        req.prefix_len = n_hit
        return n_hit, blocks

    def _prefix_insert(self, req: Request) -> None:
        """Offer the request's prompt KV (rows 0..S-1 of its slot)."""
        if self.prefix is not None and req.prompt_len:
            self.prefix.insert(req.prompt, req.slot)

    def _seed_rows(self, slot: int, blocks) -> None:
        """Copy the tree's matched slot-pool blocks into ``slot``'s rows
        (slot row == position, so a block never lands on rows of another
        block; a block already in ``slot`` stays where it is)."""
        for l in range(self.L):
            for s, a, b in blocks:
                if s != slot:
                    self._K[l][slot, a:b] = self._K[l][s, a:b]
                    self._V[l][slot, a:b] = self._V[l][s, a:b]

    def _pool_row(self, slot: int):
        """``slot``'s per-layer [1, W, Hkv, hd] pool rows (views, written in
        place by ``prefill_chunk``) and a device copy of its positions."""
        return ([k[slot:slot + 1] for k in self._K],
                [v[slot:slot + 1] for v in self._V],
                torch.tensor(self._slot_pos[slot:slot + 1], device=self.device))

    def _release_expert_contributions(self, req: Request) -> None:
        """Drop the residency entries the request's prefill chunks / last
        decode step touched that no other in-flight request touched. A
        drop frees the slot through the same hooks as an eviction, so the
        next copy into it waits on the slot's last-use event and follows
        any copy still in flight on the copy stream (core/cache.py)."""
        def touched(r: Request) -> Set[ExpertKey]:
            keys: Set[ExpertKey] = set()
            if r.active_sets is not None:          # mid-prefill
                for l, s in enumerate(r.active_sets):
                    keys |= {(l, int(e)) for e in s}
            for l, acts in enumerate(r.prefill_active):
                keys |= {(l, int(e)) for e in acts}
            if r.trace:                            # last decode step
                for l in range(self.L):
                    keys |= {(l, int(e)) for e in r.trace[-1][l]}
            return keys

        mine = touched(req)
        for other in self.prefilling + self.running + self.held:
            if other is not req:
                mine -= touched(other)
        for key in mine:
            if self.cache.contains(key) and not self.cache.resident[key]:
                self.cache.drop(key)

    # -- snapshot / restore -------------------------------------------------
    def find_request(self, rid: int) -> Optional[Request]:
        """The live (queued/prefilling/running/held) request `rid`, or None."""
        for r in (list(self.queue.pending) + self.prefilling
                  + self.running + self.held):
            if r.rid == rid:
                return r
        return None

    def prefix_score(self, prompt, limit: Optional[int] = None) -> int:
        """Longest leading run of `prompt` this engine could serve from
        cache by the time it prefills: the tree plus every live prompt."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = (int(prompt.shape[0]) if limit is None
               else min(int(limit), int(prompt.shape[0])))
        if cap <= 0:
            return 0
        best = self.prefix.peek(prompt, limit=cap)
        for r in (list(self.queue.pending) + self.prefilling
                  + self.running + self.held):
            n = min(cap, r.prompt_len)
            if n <= best:
                continue
            neq = np.nonzero(r.prompt[:n] != prompt[:n])[0]
            best = max(best, int(neq[0]) if neq.size else n)
        return best

    def prefix_head_for(self, req: Request) -> int:
        """Leading KV rows of `req` this engine could rebuild from its own
        prefix tree (the head a tail-only handoff need not ship)."""
        if self.prefix is None or req.state == "queued":
            return 0
        have = (req.prefill_pos if req.state == "prefilling" else req.pos)
        cap = min(req.prompt_len, have)
        if cap <= 0:
            return 0
        return self.prefix.peek(req.prompt, limit=cap)

    def snapshot(self, req: Union[Request, int], *,
                 kv_start: int = 0) -> RequestSnapshot:
        """Pause a live request into a host-side ``RequestSnapshot``: its KV
        rows [kv_start, P) copied to host tensors, its resources released
        as by ``cancel`` (no FinishEvent; state 'paused')."""
        if isinstance(req, int):
            found = self.find_request(req)
            if found is None:
                raise KeyError(f"no live request with rid {req}")
            req = found
        if req.state not in ("queued", "prefilling", "running", "held"):
            raise ValueError(f"snapshot from state {req.state!r}")
        if req.done:
            raise ValueError("snapshot of a finished request")
        spec = GenerationRequest(
            prompt=req.prompt, params=req.params, ttft_slo=req.ttft_slo,
            tbt_slo=req.tbt_slo, priority=req.priority, arrival=req.arrival)
        kv_k: List[torch.Tensor] = []
        kv_v: List[torch.Tensor] = []
        host = dict(device="cpu", copy=True)
        if req.state == "queued":
            if kv_start:
                raise ValueError("a queued snapshot carries no KV")
            if not self.queue.remove(req):
                raise AssertionError("queued request not in its queue")
            state = "queued"
        elif req.state == "prefilling":
            P = req.prefill_pos
            if not 0 <= kv_start <= min(P, req.prompt_len):
                raise ValueError(f"kv_start {kv_start} outside the prompt rows")
            for l in range(self.L):
                kv_k.append(self._K[l][req.slot, kv_start:P].to(**host))
                kv_v.append(self._V[l][req.slot, kv_start:P].to(**host))
            self.prefilling.remove(req)
            self._release_expert_contributions(req)
            self._release_slot(req)
            state = "prefilling"
        else:
            # running/held: positions 0..pos-1 are written (the latest
            # token's KV lands when IT is decoded)
            P = req.pos
            if not 0 <= kv_start <= min(P, req.prompt_len):
                raise ValueError(f"kv_start {kv_start} outside the prompt rows")
            for l in range(self.L):
                kv_k.append(self._K[l][req.slot, kv_start:P].to(**host))
                kv_v.append(self._V[l][req.slot, kv_start:P].to(**host))
            (self.running if req.state == "running"
             else self.held).remove(req)
            self._release_expert_contributions(req)
            self._release_slot(req)
            state = "running"
        snap = RequestSnapshot(
            spec=spec, state=state, tokens=list(req.tokens),
            kv_k=kv_k, kv_v=kv_v, prefill_pos=req.prefill_pos,
            active_sets=([sorted(int(e) for e in s)
                          for s in req.active_sets]
                         if req.active_sets is not None else None),
            prefill_active=[list(map(int, a)) for a in req.prefill_active],
            trace=list(req.trace), pred=list(req.pred),
            hits=req.hits, misses=req.misses,
            t_start=req.t_start, t_first=req.t_first,
            tbt_gaps=list(self.tbt.by_rid.get(req.rid, ())),
            rng_state=(req.rng.bit_generator.state
                       if req.rng is not None else None),
            source_rid=req.rid, t_snapshot=monotonic(),
            kv_start=kv_start)
        self.tbt.close(req.rid)
        self.obs.instant("request.paused", rid=req.rid,
                         kv_bytes=snap.kv_bytes, state=state)
        req.state = "paused"
        req.slot = -1
        req.active_sets = None
        return snap

    def can_restore(self, snap: RequestSnapshot) -> bool:
        """Whether ``restore(snap)`` would succeed right now."""
        prompt = np.asarray(snap.spec.prompt).reshape(-1)
        need = int(prompt.shape[0]) + snap.spec.params.max_new_tokens + 1
        if need > self.W:
            return False
        if snap.kv_start and (
                self.prefix is None
                or self.prefix.peek(prompt,
                                    limit=snap.kv_start) < snap.kv_start):
            return False
        if snap.state == "queued":
            return True
        return self.slot_available and \
            (snap.state != "prefilling" or self.chunked)

    def restore(self, snap: RequestSnapshot) -> Request:
        """Resume a snapshot on THIS engine as a fresh request (new rid):
        rng state, tokens and KV prefix carried, so the continuation is
        bit-exact. The dense KV rows land at positions 0..P-1 of a free
        slot and every later ring position stays -1 (masked)."""
        spec = snap.spec
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(spec.prompt, np.int32).reshape(-1),
                      params=spec.params, arrival=spec.arrival,
                      ttft_slo=spec.ttft_slo, tbt_slo=spec.tbt_slo,
                      priority=spec.priority)
        need = req.prompt_len + req.max_new + 1
        if need > self.W:
            raise ValueError(f"restored request needs {need} slots > W={self.W}")
        self._next_rid += 1
        req.rng = np.random.default_rng()
        if snap.rng_state is not None:
            req.rng.bit_generator.state = snap.rng_state
        req.tokens = list(snap.tokens)
        req.trace = list(snap.trace)
        req.pred = list(snap.pred)
        req.hits, req.misses = snap.hits, snap.misses
        req.t_start, req.t_first = snap.t_start, snap.t_first
        req.prefill_active = [list(a) for a in snap.prefill_active]
        if snap.state == "queued":
            req.state = "queued"
            self.queue.submit(req)
            self.obs.instant("request.restored", rid=req.rid,
                             source_rid=snap.source_rid, state="queued")
            return req
        # tail-only snapshot: match (and pin) the shared head in THIS
        # engine's tree before acquiring a slot, which may evict tree cache
        head = snap.kv_start
        blocks: List = []
        if head:
            if self.prefix is None:
                raise ValueError("tail-only snapshot needs a prefix tree")
            n_hit, blocks = self.prefix.match(req.prompt, limit=head)
            if n_hit != head:
                raise ValueError(f"target lost the shared head: have {n_hit} "
                                 f"of {head} rows")
            req.prefix_len = head
        if not self.slot_available:
            raise RuntimeError("no free KV slot to restore into")
        slot = self._acquire_slot()
        req.slot = slot
        self._slot_pos[slot, :] = -1
        if snap.state == "prefilling":
            if not self.chunked:
                raise ValueError("mid-prefill restore needs a chunked engine")
            P = snap.prefill_pos
        elif snap.state == "running":
            P = req.pos
        else:
            raise ValueError(f"bad snapshot state {snap.state!r}")
        self._seed_rows(slot, blocks)
        if P > head:
            for l in range(self.L):
                self._K[l][slot, head:P] = snap.kv_k[l].to(self.device)
                self._V[l][slot, head:P] = snap.kv_v[l].to(self.device)
        self._slot_pos[slot, :P] = np.arange(P, dtype=np.int32)
        if snap.state == "prefilling":
            req.state = "prefilling"
            req.prefill_pos = P
            req.active_sets = [set(s) for s in snap.active_sets]
            self.prefilling.append(req)
        else:
            req.prefill_pos = req.prompt_len
            self._prefix_insert(req)
            self._finish_prefill(req)   # running, or held on role='prefill'
        if head:
            self.prefix.release(req.prompt, head)   # head rows are copied
        self.tbt.reopen(req.rid, snap.tbt_gaps)
        self.obs.instant("request.restored", rid=req.rid,
                         source_rid=snap.source_rid, state=req.state)
        return req

    # -- prefill phase ------------------------------------------------------
    def _admit_and_prefill(self, now: float) -> List[Request]:
        """Admit queue arrivals into free KV slots: monolithic mode
        prefills each here; chunked mode only moves it to 'prefilling'."""
        n_rej = len(self.queue.rejected)
        backlog = sum(r.prefill_remaining for r in self.prefilling)
        free_now = len(self._free) + (self.prefix.n_reclaimable()
                                      if self.prefix is not None else 0)
        newly = self.queue.pop_admissible(
            now, limit=free_now, backlog_tokens=backlog,
            running_batch=len(self.running),
            chunk_budget=self._current_budget(),
            chunk_adaptive=self.prefill_budget == "auto",
            hit_fn=(self._prefix_peek if self.prefix is not None else None))
        for r in self.queue.rejected[n_rej:]:
            self.obs.terminal(r.rid, "rejected", reason_detail="slo")
            self._emit(RejectEvent(rid=r.rid, reason="slo",
                                   t=time.perf_counter()))
        for req in newly:
            req.t_start = now
            self.obs.instant("request.admitted", rid=req.rid)
            # the pin on the matched path is released before _acquire_slot,
            # which may evict any tree-owned slot (the matched blocks' own
            # among them): an evicted slot is written only once acquired,
            # and this request's rows are copied right after its acquire
            n_hit, blocks = self._prefix_match(req)
            if n_hit:
                self.prefix.release(req.prompt, n_hit)
            slot = self._acquire_slot()
            req.slot = slot
            self._slot_pos[slot, :] = -1
            self._seed_rows(slot, blocks)
            self._slot_pos[slot, :n_hit] = np.arange(n_hit, dtype=np.int32)
            if self.chunked:
                req.state = "prefilling"
                req.prefill_pos = n_hit
                req.active_sets = [set() for _ in range(self.L)]
                self.prefilling.append(req)
                continue
            req.state = "running"
            t0 = time.perf_counter()
            S = req.prompt_len
            pt = self.obs.begin("prefill", lane="prefill", rid=req.rid,
                                tokens=S - n_hit)
            if n_hit:
                # monolithic engine with a hit: the un-hit suffix as ONE
                # chunk over the seeded pool rows
                logits, _, _, _, active, _ = self.prefill_chunk(
                    req.prompt[None, n_hit:], n_hit, *self._pool_row(slot),
                    need_logits=True)
                active = [sorted(set(a)) for a in active]
            else:
                logits, (kc, vc), active, _ = self.prefill_layers(
                    req.prompt.reshape(1, -1))
                for l in range(self.L):
                    self._K[l][slot, :S] = kc[l][0]
                    self._V[l][slot, :S] = vc[l][0]
            self._slot_pos[slot, :S] = np.arange(S, dtype=np.int32)
            req.prefill_pos = S
            req.prefill_active = active
            self._c_prefilled.inc(S - n_hit)
            self._prefix_insert(req)
            tok = self._sample_req(req, _logits_row(logits))
            self._emit_token(req, tok, time.perf_counter(), first=True)
            self.queue.admission.model.observe_prefill(S - n_hit,
                                                       req.t_first - t0)
            self.obs.end(pt)
            self._finish_prefill(req)
        return newly

    def _finish_prefill(self, req: Request) -> None:
        """Prefill done, first token emitted: a role='prefill' replica holds
        the request for a KV handoff; every other role decodes it."""
        if self.role == "prefill":
            req.state = "held"
            self.held.append(req)
        else:
            req.state = "running"
            self.running.append(req)

    def _run_prefill_chunk(self, req: Request, C: int) -> None:
        """Advance one 'prefilling' request by a C-token chunk, its K/V
        written into its pool rows in place; the final chunk samples the
        first token and joins this step's decode batch."""
        t0 = time.perf_counter()
        slot, start = req.slot, req.prefill_pos
        stop = start + C
        final = stop == req.prompt_len
        pt = self.obs.begin("prefill.chunk", lane="prefill", rid=req.rid,
                            start=start, tokens=C)
        logits, _, _, _, act, _ = self.prefill_chunk(
            req.prompt[None, start:stop], start, *self._pool_row(slot),
            need_logits=final)
        self._slot_pos[slot, start:stop] = np.arange(start, stop, dtype=np.int32)
        for l in range(self.L):
            req.active_sets[l].update(act[l])
        req.prefill_pos = stop
        self._c_prefilled.inc(C)
        self.queue.admission.model.observe_prefill(
            C, time.perf_counter() - t0)
        if final:
            req.prefill_active = [sorted(s) for s in req.active_sets]
            req.active_sets = None
            self._prefix_insert(req)
            tok = self._sample_req(req, _logits_row(logits))
            self._emit_token(req, tok, time.perf_counter(), first=True)
            self.prefilling.remove(req)
            self._finish_prefill(req)
        self.obs.end(pt, final=final)

    def _prefill_work(self) -> int:
        """Spend up to this step's prefill budget on 'prefilling' requests
        (fifo / rr / srf order, one request at a time, spilling to the next
        when one finishes early). Returns tokens of work done."""
        if not self.chunked:
            return 0  # monolithic mode: prefill happened at admission
        budget = self._current_budget()
        spent = 0
        if self.prefilling and self.prefill_fairness == "rr":
            rot = self._pf_rr % len(self.prefilling)
            self._pf_rr += 1
            order = self.prefilling[rot:] + self.prefilling[:rot]
        elif self.prefilling and self.prefill_fairness == "srf":
            order = sorted(self.prefilling,
                           key=lambda r: (r.prefill_remaining, r.rid))
        else:
            order = list(self.prefilling)  # fifo: head-of-line
        for req in order:
            if budget <= 0:
                break
            C = min(budget, req.prefill_remaining)
            self._run_prefill_chunk(req, C)
            spent += C
            budget -= C
        return spent

    def _sample_req(self, req: Request, logits_row: np.ndarray) -> int:
        """Sample from an f64 host logits row with the request's rng."""
        temp = (self.temperature if req.temperature is None
                else req.temperature)
        return self.sample_row(logits_row, temp, req.rng)

    # -- decode phase -------------------------------------------------------
    def _kv_rows(self, l: int, idx: np.ndarray):
        """The batch's pool rows of layer l: (K, V, None) as views when the
        slots are consecutive and in order (the layer writes into the pool
        itself), else gather copies and the row index the caller writes the
        new rows back through."""
        lo = int(idx[0])
        if np.array_equal(idx, np.arange(lo, lo + idx.size)):
            hi = lo + idx.size
            return self._K[l][lo:hi], self._V[l][lo:hi], None
        jidx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        return self._K[l][jidx], self._V[l][jidx], jidx

    def _decode_step(self, batch: List[Request]) -> None:
        """One batched decode step: every request advances by one token.
        Rows accumulate their experts in their own top-k order on both the
        grouped sweep and the dense baseline."""
        B = len(batch)
        t0 = time.perf_counter()
        dt = self.obs.begin("decode.step", lane="decode", batch=B)
        idx = np.asarray([r.slot for r in batch], np.int64)
        toks = np.asarray([[r.tokens[-1]] for r in batch], np.int32)
        pos_np = np.asarray([r.pos for r in batch], np.int32)
        slot_np = pos_np % self.W
        for b in range(B):
            self._slot_pos[idx[b], slot_np[b]] = pos_np[b]
        dev = self.device
        sp = torch.as_tensor(self._slot_pos[idx], device=dev)
        pos = torch.as_tensor(pos_np, device=dev)
        slot = torch.as_tensor(slot_np, dtype=torch.long, device=dev)
        rows = torch.arange(B, device=dev)

        x = self._embed(toks)
        if isinstance(self.sched, DuoServeScheduler):
            self.sched.begin_decode_step()
        step_trace = np.zeros((B, self.L, self.k), np.int32)
        step_pred = np.full((B, self.L, self.k), -1, np.int32)
        for l in range(self.L):
            lp = self._layers[l]
            ck, cv, jidx = self._kv_rows(l, idx)
            x, ck, cv = self._attn_decode_batched(lp, x, ck, cv, sp, slot, pos)
            if jidx is not None:
                self._K[l][jidx, slot] = ck[rows, slot]
                self._V[l][jidx, slot] = cv[rows, slot]
            self.obs.instant("kv.scatter", lane="decode", layer=l, rows=B)
            xn, w, ids = self._gate(self._moe[l], lp, x)
            ids_np = ids.cpu().numpy().reshape(B, self.k)
            step_trace[:, l] = ids_np
            selections = [list(map(int, ids_np[b])) for b in range(B)]
            plan = self.sched.decode_plan(l, selections)
            # hits + misses together cover exactly the distinct selections
            union = plan.hits + plan.misses
            np_pred = plan.predicted[: self.k]
            step_pred[:, l, : len(np_pred)] = np_pred
            # correction fetches for misses (sync point #1), once per expert
            if plan.misses:
                ct = self.obs.begin("prefetch.correction", lane="prefetch",
                                    layer=l, n=len(plan.misses))
                for e in plan.misses:
                    self.cache.prefetch((l, e))
                    self.cache.wait((l, e))
                self.obs.end(ct)
            hit_set, miss_set = set(plan.hits), set(plan.misses)
            for b, r in enumerate(batch):
                r.hits += len(set(selections[b]) & hit_set)
                r.misses += len(set(selections[b]) & miss_set)
            self.perf.inc("decode_layers")
            self.perf.inc("decode_rows_dense", len(union) * B)
            acc = self._shared(self._moe[l], xn)
            if union and self.grouped_decode:
                # one launch computes only each expert's selecting rows
                # ([U, C, d]); the scatter-back walks j = 0..k-1 so every
                # row accumulates in its own top-k order
                disp = group_by_expert(ids_np, union, bucket_cap=B,
                                       u_bucket_cap=min(self.E, B * self.k))
                raw_g, _ = self._grouped_ffn_raw(l, union, xn, disp.row_idx)
                self.obs.instant("ffn.launch", lane="decode", layer=l,
                                 rows=disp.n_launched)
                self.perf.inc("decode_ffn_launches")
                self.perf.inc("decode_rows_grouped", disp.n_rows)
                self.perf.inc("decode_rows_launched", disp.n_launched)
                u_of = torch.as_tensor(disp.u_of, dtype=torch.long, device=dev)
                c_of = torch.as_tensor(disp.c_of, dtype=torch.long, device=dev)
                for j in range(self.k):
                    y = raw_g[u_of[:, j], c_of[:, j]]   # f32 [B, d]
                    acc = acc + (y * w[:, j, None]).to(acc.dtype)
            elif union:
                # dense baseline: one pre-gate output per distinct expert
                # over all B rows, read by slot out of the residency pools
                raw: Dict[int, torch.Tensor] = {}
                for e in union:
                    eslot = self.cache.slot((l, e))
                    raw[e] = self._expert_raw(xn, *self.cache.pools, eslot)
                    self.cache.mark_used([eslot])
                self.obs.instant("ffn.launch", lane="decode", layer=l,
                                 rows=len(union) * B, launches=len(union))
                self.perf.inc("decode_ffn_launches", len(union))
                self.perf.inc("decode_rows_launched", len(union) * B)
                stacked = torch.stack([raw[e] for e in union])  # [U, B, d]
                inv = np.zeros(self.E, np.int64)
                for u, e in enumerate(union):
                    inv[e] = u
                for j in range(self.k):
                    # j-th choice of every row, in that row's top-k order
                    u_j = torch.as_tensor(inv[ids_np[:, j]], device=dev)
                    y = stacked[u_j, rows]
                    acc = acc + (y * w[:, j, None]).to(acc.dtype)
            x = x + acc.reshape(x.shape)
            # prediction stream: prefetch layer l+1's experts for the batch
            if plan.prefetch_next:
                self.obs.instant("prefetch.dispatch", lane="prefetch",
                                 layer=l, n=len(plan.prefetch_next))
            for e in plan.prefetch_next:
                self.cache.prefetch((l + 1, e))
        # unpin the successor-less last layer: without this, a continuously
        # batching engine (which never calls begin_request) accumulates
        # pinned (L-1, e) entries forever
        self.sched.end_layer(self.L - 1)
        lg_np = self._head(x[:, -1]).cpu().numpy().astype(np.float64)
        t_tok = time.perf_counter()
        for b, r in enumerate(batch):
            self._emit_token(r, self._sample_req(r, lg_np[b]), t_tok)
            r.trace.append(step_trace[b])
            r.pred.append(step_pred[b])
        self.queue.admission.model.observe_decode_step(t_tok - t0)
        self.decode_step_wall.append(t_tok - t0)
        self.decode_batch_hist.append(B)
        self._h_step.observe(t_tok - t0)
        self.obs.end(dt, batch=B)

    # -- scheduler loop -----------------------------------------------------
    def step(self, now: Optional[float] = None) -> StepEvents:
        """One engine iteration: admit arrivals, spend the prefill budget,
        then one batched decode step for every in-flight request. Returns
        the step's events; ``did_work`` says whether anything was done."""
        now = time.perf_counter() if now is None else now
        admitted = self._admit_and_prefill(now)
        prefilled = self._prefill_work()
        batch = [r for r in self.running if not r.done]
        if batch:
            self._decode_step(batch)
        did_work = bool(admitted or prefilled or batch)
        self.step_count += 1
        # retire finished requests (held ones can finish at their FIRST
        # token without ever reaching a decode replica)
        self.running = [r for r in self.running if not self._retire(r)]
        self.held = [r for r in self.held if not self._retire(r)]
        return StepEvents(self.drain_events(), did_work)

    def _retire(self, r: Request) -> bool:
        if not r.done:
            return False
        r.state = "done"
        if r.finish_reason is None:
            r.finish_reason = "length"
        r.t_done = time.perf_counter()
        self._release_slot(r)
        self.finished.append(r)
        self.tbt.close(r.rid)
        self.obs.terminal(r.rid, r.finish_reason, n_tokens=len(r.tokens))
        self._emit(FinishEvent(rid=r.rid, reason=r.finish_reason,
                               n_tokens=len(r.tokens), t=r.t_done))
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> Deque[Request]:
        """Drive step() until nothing is queued, prefilling, running or
        held; returns the finished-request records."""
        for _ in range(max_steps):
            self.step()
            if self.idle:
                break
        return self.finished
