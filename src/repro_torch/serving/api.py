"""Typed serving API: request specs, sampling params, and the event stream.

Copy of ``repro.serving.api`` (numpy only). One difference: a
``RequestSnapshot`` carries its KV rows as host (CPU) torch tensors, since
numpy has no bfloat16. This module is the public vocabulary of the
continuous-batching engine (``serving/batching.py``):

  * ``SamplingParams`` — frozen per-request sampling spec (temperature,
    max_new_tokens, stop_token_ids, seed). Replaces the scattered
    ``temperature=`` / ``max_new=`` kwargs the engines used to take.
  * ``GenerationRequest`` — one request as the caller describes it: prompt,
    sampling params, QoS targets (ttft_slo, tbt_slo), scheduling priority,
    and arrival time. The engine turns this into its internal runtime
    ``Request`` record at submission.
  * ``TokenEvent`` / ``FinishEvent`` / ``RejectEvent`` — the per-step event
    stream ``BatchedServingEngine.step()`` emits instead of mutating token
    lists as its only output. ``StepEvents`` is one step's batch of events
    plus a ``did_work`` flag (admission / prefill-chunk work can be real
    work that emits no token yet).

Nothing here imports the engines or torch, so the spec types are
importable from anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request sampling specification.

    temperature: None = use the engine's default temperature; <= 0 = greedy.
    max_new_tokens: decode steps after the first token — a request emits at
        most ``max_new_tokens + 1`` tokens total (first token included),
        matching the engines' historical ``max_new`` semantics.
    stop_token_ids: early-termination set — the stop token itself is still
        emitted (so streams stay bit-comparable to un-stopped runs up to and
        including the stop position), then the request finishes with reason
        ``"stop_token"``.
    seed: per-request sampling seed; None derives one from the engine seed
        and the request id (deterministic per submission order).
    """
    temperature: Optional[float] = None
    max_new_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        # normalize any iterable of stop ids into a hashable int tuple
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")


@dataclasses.dataclass(frozen=True, eq=False)
class GenerationRequest:
    """One serving request as the caller specifies it (spec, not state).

    prompt: [S] int32 token ids.
    params: sampling spec (see SamplingParams).
    ttft_slo: deadline (seconds, arrival -> first token) for SLO-aware
        admission; None = no deadline.
    tbt_slo: per-request inter-token-gap target (seconds). Admission rejects
        requests whose steady-state gap is structurally unmeetable, and the
        engine's ``prefill_budget="auto"`` tightens its chunk to the minimum
        tbt_slo across in-flight requests.
    priority: higher = served first; ``RequestQueue.pop_admissible`` orders
        candidates by (priority desc, arrival order) — stable, so equal
        priorities keep FIFO.
    arrival: wall-clock arrival time (time.perf_counter domain); None =
        stamped at submission.
    """
    prompt: np.ndarray
    params: SamplingParams = SamplingParams()
    ttft_slo: Optional[float] = None
    tbt_slo: Optional[float] = None
    priority: int = 0
    arrival: Optional[float] = None


def as_request_spec(spec, **kw) -> GenerationRequest:
    """Normalize a front-end ``submit()`` input: pass a GenerationRequest
    through untouched (field kwargs are then disallowed), or build one from
    a raw prompt array plus GenerationRequest fields. Shared by
    ServingFrontend and ClusterFrontend so the two surfaces cannot drift."""
    if isinstance(spec, GenerationRequest):
        if kw:
            raise ValueError("kwargs are ignored when a full GenerationRequest "
                             "is passed — set the fields on the spec instead")
        return spec
    return GenerationRequest(
        prompt=np.asarray(spec, np.int32).reshape(-1), **kw)


# ---------------------------------------------------------------------------
# request snapshot (pause / handoff / migration primitive)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestSnapshot:
    """A paused request, portable across engines
    (``BatchedServingEngine.snapshot(rid)`` / ``restore(snapshot)``).

    Captures everything needed to resume the request bit-exactly on ANY
    engine whose per-slot KV capacity fits it: the immutable spec, the
    tokens generated so far, the per-layer KV prefix (gathered host-side —
    dense, row p = position p, so ring positions rebuild as ``arange``),
    mid-prefill progress, the per-request decode traces/counters, the
    sampling rng state (carried, never re-derived — a re-derived stream
    would break bit-exactness for temperature > 0), and the TBT-ledger gap
    history (re-seeded via ``TBTLedger.reopen`` so paused wall time is
    never charged as an inter-token gap).

    state is the LOGICAL resume point, not the verbatim source state:
    ``queued`` (never started — re-enqueues without a KV slot),
    ``prefilling`` (mid-prefill, ``prefill_pos`` prompt tokens of KV
    captured), or ``running`` (prefill complete — a ``held`` request on a
    prefill-role replica snapshots as ``running`` and a decode-capable
    engine resumes it straight into its batch).

    Consumers: QosAutopilot preemption (pause low-priority, resume on
    headroom), disaggregated prefill->decode handoff, and replica draining
    (serving/cluster.py). While a snapshot exists its KV lives HOST-side —
    ``kv_bytes`` is what memory accounting should charge there.
    """
    spec: GenerationRequest
    state: str                       # queued | prefilling | running
    tokens: List[int]
    kv_k: List                       # per layer [P, n_kv_heads, hd], host
    kv_v: List                       # torch tensors
    prefill_pos: int
    active_sets: Optional[List[List[int]]]  # accumulating expert sets
    prefill_active: List[List[int]]
    trace: List[np.ndarray]
    pred: List[np.ndarray]
    hits: int
    misses: int
    t_start: float
    t_first: float
    tbt_gaps: List[float]
    rng_state: Optional[dict]
    source_rid: int
    t_snapshot: float
    # tail-only handoff (cross-request prefix reuse, core/prefix.py): the
    # dense kv_k/kv_v arrays cover positions [kv_start, P) — the shared
    # head [0, kv_start) is NOT shipped, the restoring engine rebuilds it
    # from its own PrefixTree (restore asserts the head is present; 0 =
    # the full-prefix snapshot every pre-existing consumer produces)
    kv_start: int = 0

    @property
    def kv_bytes(self) -> int:
        """Host bytes the captured KV prefix occupies while paused (a
        tail-only snapshot only counts the rows it actually carries)."""
        return sum(a.nbytes for a in self.kv_k) + \
            sum(a.nbytes for a in self.kv_v)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


# ---------------------------------------------------------------------------
# event stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """Request `rid` emitted generated token `token` (its `index`-th) at
    wall time `t`; `first` marks the TTFT token."""
    rid: int
    token: int
    index: int
    t: float
    first: bool = False


@dataclasses.dataclass(frozen=True)
class FinishEvent:
    """Request `rid` left the engine: reason is ``"length"`` (max_new_tokens
    reached), ``"stop_token"``, ``"cancelled"`` (caller-initiated), or
    ``"slo_shed"`` (QosAutopilot shed a request whose TTFT/TBT deadline was
    already unmeetable mid-flight). After a FinishEvent the engine emits no
    further events for `rid` — ever."""
    rid: int
    reason: str
    n_tokens: int
    t: float


@dataclasses.dataclass(frozen=True)
class RejectEvent:
    """Request `rid` was shed before it ran: reason ``"slo"`` (engine
    admission predicted an SLO breach) or ``"router_slo"`` (the cluster's
    slo_headroom router found NO replica able to meet its deadlines)."""
    rid: int
    reason: str
    t: float


Event = Union[TokenEvent, FinishEvent, RejectEvent]


class StepEvents(list):
    """One ``step()``'s events, in emission order, plus ``did_work``.

    A list subclass so existing consumers can iterate/len it directly;
    ``did_work`` is True when the step admitted, prefilled, or decoded
    anything — prefill-chunk work is real work that may emit no event, so
    idle detection must use ``did_work`` (or the engine's ``idle``
    property), not truthiness of the list.
    """

    def __init__(self, events: Iterable[Event] = (), did_work: bool = False):
        super().__init__(events)
        self.did_work = did_work

    def for_rid(self, rid: int) -> "StepEvents":
        return StepEvents([e for e in self if e.rid == rid], self.did_work)
