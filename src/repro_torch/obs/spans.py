"""Request-lifecycle and engine-phase span recorder (port of
``repro.obs.spans``).

One :class:`SpanRecorder` per engine (``engine.obs``, stamped with its
replica index by ``ReplicaPool``): ``begin``/``end`` spans and ``instant``
marks on the four ``SPAN_LANES``, and one ``terminal`` record per request
id. Off by default — every method starts with an ``enabled`` check —
bounded by a ring of closed spans, with open spans kept apart so ring
eviction cannot orphan one, and rid-sampled by a deterministic hash.
``monotonic()`` is the one clock of spans, ``RequestSnapshot.t_snapshot``
and ``RequestHandle.handoffs``' ``t_restore``, so a handoff latency is a
difference of one clock.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

# one monotonic clock for every span and handoff stamp
monotonic = time.perf_counter

# lane taxonomy: one Perfetto track-thread per lane, per replica-process
SPAN_LANES = ("lifecycle", "prefill", "decode", "prefetch")

# Knuth multiplicative hash for deterministic rid sampling
_HASH_K = 2654435761
_HASH_M = float(1 << 32)


@dataclass
class Span:
    """One recorded interval (or instant, when ``t1 == t0``)."""
    name: str
    lane: str
    t0: float
    t1: float
    rid: Optional[int] = None
    args: Dict[str, object] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class SpanRecorder:
    """Ring-buffer-bounded span sink for one engine/replica."""

    def __init__(self, enabled: bool = False, capacity: int = 8192,
                 sample: float = 1.0, replica: int = 0):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.sample = float(sample)
        self.replica = int(replica)
        self.closed: Deque[Span] = collections.deque(maxlen=self.capacity)
        self._open: Dict[int, Span] = {}
        self._next_token = 0
        # rid -> terminal reason, a bounded FIFO
        self._terminal: Dict[int, str] = {}
        self._terminal_order: Deque[int] = collections.deque()
        self._terminal_window = max(4 * self.capacity, 65536)
        self.n_dropped = 0  # closed spans evicted by the ring

    def sampled(self, rid: Optional[int]) -> bool:
        """Deterministic: the same rid is kept or dropped consistently."""
        if rid is None or self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return ((abs(int(rid)) * _HASH_K) & 0xFFFFFFFF) / _HASH_M < self.sample

    def begin(self, name: str, lane: str = "lifecycle",
              rid: Optional[int] = None, **args) -> Optional[int]:
        """Open a span; returns a token for ``end`` (None when disabled or
        sampled out — ``end(None)`` is a no-op)."""
        if not self.enabled or not self.sampled(rid):
            return None
        tok = self._next_token
        self._next_token += 1
        self._open[tok] = Span(name, lane, monotonic(), 0.0, rid, args)
        return tok

    def end(self, token: Optional[int], **args) -> None:
        if token is None:
            return
        span = self._open.pop(token, None)
        if span is None:
            raise ValueError(f"span token {token} ended twice or never opened")
        span.t1 = monotonic()
        span.args.update(args)
        self._close(span)

    def instant(self, name: str, lane: str = "lifecycle",
                rid: Optional[int] = None, **args) -> None:
        if not self.enabled or not self.sampled(rid):
            return
        t = monotonic()
        self._close(Span(name, lane, t, t, rid, args))

    def terminal(self, rid: int, reason: str, **args) -> None:
        """Record the request's ONE terminal transition; a second terminal
        for the same rid is a lifecycle bug and raises."""
        if not self.enabled:
            return
        prev = self._terminal.get(rid)
        if prev is not None:
            raise RuntimeError(f"rid {rid} reached a second terminal "
                               f"{reason!r} (already {prev!r})")
        self._terminal[rid] = reason
        self._terminal_order.append(rid)
        while len(self._terminal_order) > self._terminal_window:
            self._terminal.pop(self._terminal_order.popleft(), None)
        self.instant(f"request.{reason}", lane="lifecycle", rid=rid,
                     reason=reason, **args)

    def _close(self, span: Span) -> None:
        if len(self.closed) == self.capacity:
            self.n_dropped += 1
        self.closed.append(span)

    def spans(self) -> List[Span]:
        """Closed spans, oldest first."""
        return list(self.closed)

    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    def terminal_reasons(self) -> Dict[int, str]:
        return dict(self._terminal)

    def clear(self) -> None:
        self.closed.clear()
        self._open.clear()
        self._terminal.clear()
        self._terminal_order.clear()
        self.n_dropped = 0
