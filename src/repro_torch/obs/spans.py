"""Engine-phase span recorder (the part of ``repro.obs.spans`` the
single-request engine uses).

One :class:`SpanRecorder` per engine (``engine.obs``): ``begin``/``end``
spans and ``instant`` marks on four lanes (lifecycle, prefill, decode,
prefetch). Off by default — every method starts with an ``enabled`` check —
bounded by a ring of closed spans, with open spans kept apart so ring
eviction cannot orphan one, and rid-sampled by a deterministic hash.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

# one monotonic clock for every span
monotonic = time.perf_counter

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
    """Ring-buffer-bounded span sink for one engine."""

    def __init__(self, enabled: bool = False, capacity: int = 8192,
                 sample: float = 1.0):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.sample = float(sample)
        self.closed: Deque[Span] = collections.deque(maxlen=self.capacity)
        self._open: Dict[int, Span] = {}
        self._next_token = 0
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

    def _close(self, span: Span) -> None:
        if len(self.closed) == self.capacity:
            self.n_dropped += 1
        self.closed.append(span)

    def spans(self) -> List[Span]:
        """Closed spans, oldest first."""
        return list(self.closed)
