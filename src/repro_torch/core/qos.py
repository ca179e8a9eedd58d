"""QoS metrics (paper §VI-A Metrics) + SLO-aware admission control.

Copy of ``repro.core.qos`` (numpy only), kept whole in the port.

Metrics: TTFT, E2E, tail latency, throughput summaries over request sets.

Admission (continuous-batching front-end): the paper's QoS claim is that
TTFT/E2E stay under the SLO; under concurrent load that only holds if the
queue sheds requests whose deadline is already unmeetable. `LatencyModel`
keeps EWMA estimates of prefill cost per token and per-step decode cost;
`AdmissionController` predicts a candidate's TTFT from the work queued ahead
of it and rejects when the prediction breaches the request's TTFT deadline.

Chunk-aware TTFT: under chunked prefill (serving/batching.py) a prompt is
processed `chunk_budget` tokens per engine iteration and every iteration
also runs one batched decode step for the in-flight decoders, so predicted
TTFT = queue wait + (backlog + own) prefill cost + #iterations x decode-step
interference. `TBTLedger` records the dual metric — per-request inter-token
gaps — which chunking bounds and monolithic prefill blows through.

Cluster routing (serving/cluster.py): `ReplicaLoad` is one engine replica's
load snapshot (queue depth, prefill backlog, outstanding decode tokens,
free KV slots) — the signal the least-loaded router ranks by — and
`AdmissionController.headroom` scores how much margin a candidate request's
SLOs would have on that replica (the slo_headroom routing policy: dispatch
to the replica with the most margin, reject only when every replica is
negative).
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class QoSSummary:
    mean_ttft: float
    mean_e2e: float
    p50_e2e: float
    p95_e2e: float
    p99_e2e: float
    tokens_per_s: float
    peak_bytes: float
    hit_rate: float
    n_requests: int

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def summarize(ttfts: Sequence[float], e2es: Sequence[float],
              total_tokens: int, peak_bytes: float = 0.0,
              hit_rate: float = 0.0) -> QoSSummary:
    e = np.asarray(e2es, float)
    return QoSSummary(
        mean_ttft=float(np.mean(ttfts)),
        mean_e2e=float(e.mean()),
        p50_e2e=float(np.percentile(e, 50)),
        p95_e2e=float(np.percentile(e, 95)),
        p99_e2e=float(np.percentile(e, 99)),
        tokens_per_s=float(total_tokens / max(e.sum(), 1e-12)),
        peak_bytes=float(peak_bytes),
        hit_rate=float(hit_rate),
        n_requests=len(e2es),
    )


def slo_attainment(e2es: Sequence[float], slo: float) -> float:
    e = np.asarray(e2es, float)
    return float((e <= slo).mean())


def percentile_report(samples: Sequence[float],
                      qs: Sequence[float] = (50, 99)) -> Dict[str, float]:
    """{'p50': ..., 'p99': ...} over a latency sample set (empty -> nan)."""
    a = np.asarray(list(samples), float)
    if a.size == 0:
        return {f"p{int(q)}": float("nan") for q in qs}
    return {f"p{int(q)}": float(np.percentile(a, q)) for q in qs}


class P2Quantile:
    """Streaming quantile estimator (P^2 algorithm, Jain & Chlamtac 1985).

    Five markers, O(1) memory and update cost, no samples retained — the
    piece that lets a days-long serving process report p50/p99 inter-token
    gaps over its WHOLE lifetime while the ledger itself only keeps a
    bounded window of raw samples.
    """

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self.count = 0
        self._init: List[float] = []          # first five observations
        self._h: List[float] = []             # marker heights
        self._n: List[float] = []             # marker positions (1-based)
        self._np: List[float] = []            # desired positions
        self._dn = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def update(self, x: float) -> None:
        self.count += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._h = sorted(self._init)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._np = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or \
                    (d <= -1 and n[i - 1] - n[i] < -1):
                d = 1.0 if d > 0 else -1.0
                # parabolic (P^2) marker height update; linear fallback
                # when the parabola would break marker monotonicity
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(d)
                    hp = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += d

    def value(self) -> float:
        if self.count == 0:
            return float("nan")
        if len(self._init) < 5:
            return float(np.percentile(self._init, self.q * 100))
        return self._h[2]


class TBTLedger:
    """Per-request inter-token-gap (time-between-tokens) ledger.

    `observe(rid, t)` marks request `rid` emitting a token at wall time `t`
    and records the gap since its previous token; `close(rid)` forgets a
    finished request's baseline. The max/p99 of these gaps is the stall
    metric chunked prefill bounds (benchmarks/bench_stall.py): a monolithic
    prefill of S tokens freezes every in-flight decoder for the whole
    prefill, which shows up here as a gap of ~ S * prefill_per_token.

    Retention: raw gap samples live in bounded deques (`window` overall,
    `per_rid_window` per request), and the per-request dict itself is
    bounded — `close(rid)` enrolls the request in a `closed_window`-deep
    FIFO whose evictees lose their `by_rid` entry — so a long-running
    server leaks neither samples nor per-request deques. Lifetime p50/p99
    survive eviction via streaming P^2 sketches and the lifetime max/count
    as scalars. Passing None for a window keeps that dimension unbounded
    (exact, benchmark mode).
    """

    def __init__(self, window: Optional[int] = 8192,
                 per_rid_window: Optional[int] = 1024,
                 closed_window: Optional[int] = 512,
                 sketch_qs: Sequence[float] = (50, 99)):
        self._last: Dict[int, float] = {}
        self.gaps: Deque[float] = collections.deque(maxlen=window)
        self.by_rid: Dict[int, Deque[float]] = {}
        self._per_rid_window = per_rid_window
        self._closed: Deque[int] = collections.deque()
        self._closed_window = closed_window
        self.sketches = {q: P2Quantile(q / 100.0) for q in sketch_qs}
        self.total_gaps = 0
        self._max = 0.0

    def observe(self, rid: int, t: float) -> None:
        last = self._last.get(rid)
        if last is not None:
            gap = t - last
            self.gaps.append(gap)
            self.by_rid.setdefault(
                rid, collections.deque(maxlen=self._per_rid_window)
            ).append(gap)
            for sk in self.sketches.values():
                sk.update(gap)
            self.total_gaps += 1
            self._max = max(self._max, gap)
        self._last[rid] = t

    def close(self, rid: int) -> None:
        """Forget a finished request's baseline; its gap history survives
        for the `closed_window` most recently closed requests, then the
        whole per-request deque is dropped (the dict itself is bounded,
        not just each deque)."""
        self._last.pop(rid, None)
        if self._closed_window is None:
            return
        if rid in self.by_rid:
            self._closed.append(rid)
        while len(self._closed) > self._closed_window:
            self.by_rid.pop(self._closed.popleft(), None)

    def reopen(self, rid: int, gaps: Sequence[float] = ()) -> None:
        """Re-seed a restored request's gap history after a host-side pause
        (serving snapshot/restore: preemption, prefill->decode handoff,
        drain migration). Deliberately sets NO baseline: the first token
        after resume records no gap, so wall time spent paused or in
        transit is never charged as an inter-token gap — without this every
        preempted request would spuriously blow its TBT SLO. The carried
        per-request gaps seed `by_rid` (so `attainment` stays correct) but
        are NOT re-fed to the aggregate window/sketches: they were already
        observed once, on the ledger that recorded them."""
        if gaps:
            self.by_rid[rid] = collections.deque(
                gaps, maxlen=self._per_rid_window)

    def max_gap(self) -> float:
        """Lifetime maximum gap (scalar — survives window eviction)."""
        return self._max

    def attainment(self, rid: int, slo: float) -> float:
        """Fraction of request `rid`'s retained gaps that met `slo` (its
        per-request TBT-SLO attainment; nan if no gaps recorded). Computed
        over the per-request window — call before the request ages out of
        `closed_window` for exact numbers."""
        gaps = self.by_rid.get(rid)
        if not gaps:
            return float("nan")
        return float(np.mean([g <= slo for g in gaps]))

    def report(self, qs: Sequence[float] = (50, 99)) -> Dict[str, float]:
        """Exact percentiles over the retained window, plus lifetime
        `max`/`n` and `p<q>_stream` P^2 estimates over everything ever
        observed (identical to the window stats until eviction starts)."""
        rep = percentile_report(self.gaps, qs)
        rep["max"] = self.max_gap()
        rep["n"] = float(self.total_gaps)
        for q, sk in self.sketches.items():
            rep[f"p{int(q)}_stream"] = sk.value()
        return rep


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """One engine replica's load snapshot (serving/cluster.py routing
    signal). All token counts are OUTSTANDING work, not historical: what
    the replica still has to do for everything it has accepted."""
    queue_depth: int        # requests waiting in the arrival queue
    queued_tokens: int      # their prompt tokens (prefill not started)
    prefill_backlog: int    # prompt tokens left for admitted 'prefilling'
    running: int            # requests in batched decode
    decode_backlog: int     # decode tokens outstanding (incl. prefilling
    #                         requests' full decode budget — committed work,
    #                         EXCEPT on role='prefill' replicas, whose
    #                         requests decode elsewhere after KV handoff)
    free_slots: int         # KV slots available for new admissions
    held: int = 0           # finished-prefill requests awaiting KV handoff
    #                         (role='prefill' replicas; they occupy a slot
    #                         but contribute no decode backlog here).
    #                         Host-PAUSED requests appear in NO field at all:
    #                         a snapshot released every engine resource, so
    #                         load — and AdmissionController.headroom, which
    #                         consumes these numbers — excludes them.

    @property
    def total_tokens(self) -> int:
        """Scalar load score: every token of work the replica has accepted
        but not yet produced (the least-loaded router's ranking key)."""
        return self.queued_tokens + self.prefill_backlog + self.decode_backlog


class Admission(enum.Enum):
    ADMIT = "admit"
    QUEUE = "queue"      # keep waiting: deadline still reachable later
    REJECT = "reject"    # predicted TTFT already breaches the deadline


class LatencyModel:
    """EWMA cost model observed from the live engine.

    prefill_per_token: seconds of prefill work per prompt token.
    decode_step: seconds per batched decode step (amortized over the batch
    by the caller if it wants per-token cost).
    Seeds are optimistic-but-nonzero so the first decisions are sane before
    any observation lands.
    """

    def __init__(self, alpha: float = 0.3, prefill_per_token: float = 1e-4,
                 decode_step: float = 1e-3):
        self.alpha = alpha
        self.prefill_per_token = prefill_per_token
        self.decode_step = decode_step
        self.n_prefills = 0
        self.n_steps = 0

    def _ewma(self, cur: float, obs: float) -> float:
        return (1 - self.alpha) * cur + self.alpha * obs

    def observe_prefill(self, n_tokens: int, wall_s: float) -> None:
        if n_tokens <= 0:
            return
        self.prefill_per_token = self._ewma(self.prefill_per_token,
                                            wall_s / n_tokens)
        self.n_prefills += 1

    def observe_decode_step(self, wall_s: float) -> None:
        self.decode_step = self._ewma(self.decode_step, wall_s)
        self.n_steps += 1

    def predict_prefill(self, n_tokens: int) -> float:
        return n_tokens * self.prefill_per_token

    def predict_tbt(self, chunk_budget: Optional[int] = None) -> float:
        """Steady-state inter-token gap a decoder sees per engine iteration:
        one batched decode step, plus — on a chunked engine — up to one
        prefill chunk of interference when prompts are prefilling. Monolithic
        engines (chunk_budget None) report the decode step only; their gaps
        are UNBOUNDED while a prefill runs (the whole point of chunking), so
        a monolithic prediction is a floor, not a guarantee."""
        gap = self.decode_step
        if chunk_budget is not None and chunk_budget > 0:
            gap += chunk_budget * self.prefill_per_token
        return gap

    def suggest_chunk(self, tbt_slo: float, floor: int = 1,
                      ceiling: int = 4096) -> int:
        """Largest prefill chunk (tokens) such that one chunk of prefill
        plus one batched decode step fits the inter-token-gap target:
        ``chunk * prefill_per_token + decode_step <= tbt_slo``. This is the
        chunk-size auto-tuner behind ``prefill_budget="auto"``
        (serving/batching.py): as the EWMA model tracks the live engine,
        the budget adapts instead of being a hand-chosen constant. Clamped
        to [floor, ceiling]; an unmeetable SLO degrades to `floor` (maximal
        chunking) rather than stalling prefill entirely."""
        room = tbt_slo - self.decode_step
        if room <= 0:
            return floor
        chunk = int(room / max(self.prefill_per_token, 1e-12))
        return int(np.clip(chunk, floor, ceiling))


class AdmissionController:
    """Predicts a candidate request's TTFT and gates admission on its SLO.

    Predicted TTFT = time already spent queued + prefill cost of the prompts
    queued ahead + the candidate's own prefill cost + decode interference.
    Monolithic engines prefill every same-round admission back-to-back
    inside one scheduler iteration, so only the single batched-step drain
    (new arrivals wait for the in-flight step to finish) separates the
    candidate from its first token. A chunked engine (`chunk_budget`)
    instead interleaves one batched decode step per chunk iteration, so
    with decoders running (`running_batch` > 0) the candidate pays one
    `decode_step` per ceil(total/chunk_budget) iterations.
    """

    def __init__(self, model: Optional[LatencyModel] = None,
                 default_ttft_slo: Optional[float] = None):
        self.model = model or LatencyModel()
        self.default_ttft_slo = default_ttft_slo
        self.n_rejected = 0

    def predict_ttft(self, now: float, arrival: float, prompt_len: int,
                     queued_tokens_ahead: int, *, running_batch: int = 0,
                     chunk_budget: Optional[int] = None) -> float:
        waited = max(now - arrival, 0.0)
        total = queued_tokens_ahead + prompt_len
        if chunk_budget is not None and chunk_budget > 0 and running_batch:
            steps = max(1, -(-total // chunk_budget))
        else:
            steps = 1
        return (waited + self.model.predict_prefill(total)
                + steps * self.model.decode_step)

    def decide(self, now: float, arrival: float, prompt_len: int,
               queued_tokens_ahead: int,
               ttft_slo: Optional[float] = None, *,
               running_batch: int = 0,
               chunk_budget: Optional[int] = None,
               tbt_slo: Optional[float] = None,
               chunk_adaptive: bool = False) -> Admission:
        """ADMIT if the predicted TTFT (incl. the backlog ahead) fits the
        deadline; QUEUE if only the backlog breaches it (it may drain, the
        deadline is still reachable); REJECT if even an immediate start
        would breach — the request is hopeless and is shed.

        tbt_slo (per-request): a structurally unmeetable inter-token-gap
        target is REJECTED outright — waiting never improves the steady
        per-step gap, so a QUEUE verdict would be a lie. The prediction
        charges the chunk the engine will actually run for this request:
        a fixed-budget engine keeps `chunk_budget` no matter what, while an
        adaptive one (`chunk_adaptive`, prefill_budget="auto") shrinks its
        chunk to the tightest in-flight tbt_slo — so only then does the
        check use min(current budget, suggest_chunk(tbt_slo))."""
        if tbt_slo is not None:
            cb = chunk_budget
            if cb is not None and chunk_adaptive:
                cb = min(cb, self.model.suggest_chunk(tbt_slo))
            if self.model.predict_tbt(cb) > tbt_slo:
                self.n_rejected += 1
                return Admission.REJECT
        slo = ttft_slo if ttft_slo is not None else self.default_ttft_slo
        if slo is None:
            return Admission.ADMIT
        if self.predict_ttft(now, arrival, prompt_len, queued_tokens_ahead,
                             running_batch=running_batch,
                             chunk_budget=chunk_budget) <= slo:
            return Admission.ADMIT
        if self.predict_ttft(now, arrival, prompt_len, 0,
                             running_batch=running_batch,
                             chunk_budget=chunk_budget) <= slo:
            return Admission.QUEUE
        self.n_rejected += 1
        return Admission.REJECT

    def headroom(self, now: float, arrival: float, prompt_len: int,
                 backlog_tokens: int, *,
                 ttft_slo: Optional[float] = None,
                 tbt_slo: Optional[float] = None,
                 running_batch: int = 0,
                 chunk_budget: Optional[int] = None,
                 chunk_adaptive: bool = False) -> float:
        """Worst-case SLO margin (seconds) this replica would leave the
        candidate: min over its deadlines of (slo - prediction). Positive =
        every deadline predicted met with that much slack; negative = at
        least one predicted breached; +inf when the request carries no SLO
        (then only load can rank replicas). The slo_headroom router
        dispatches to the max-headroom replica and rejects only when NO
        replica is non-negative."""
        h = float("inf")
        if tbt_slo is not None:
            cb = chunk_budget
            if cb is not None and chunk_adaptive:
                cb = min(cb, self.model.suggest_chunk(tbt_slo))
            h = min(h, tbt_slo - self.model.predict_tbt(cb))
        slo = ttft_slo if ttft_slo is not None else self.default_ttft_slo
        if slo is not None:
            h = min(h, slo - self.predict_ttft(
                now, arrival, prompt_len, backlog_tokens,
                running_batch=running_batch, chunk_budget=chunk_budget))
        return h
