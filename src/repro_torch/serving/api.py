"""Serving API vocabulary (the part of ``repro.serving.api`` the
single-request engine uses): ``SamplingParams`` and the token event."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request sampling specification.

    temperature: None = the engine's default; <= 0 = greedy.
    max_new_tokens: decode steps after the first token — a request emits at
        most ``max_new_tokens + 1`` tokens, first token included.
    stop_token_ids: early termination; the stop token itself is emitted.
    seed: per-request sampling seed; None uses the engine's generator.
    """
    temperature: Optional[float] = None
    max_new_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """Request `rid` emitted generated token `token` (its `index`-th) at
    wall time `t`; `first` marks the time-to-first-token token."""
    rid: int
    token: int
    index: int
    t: float
    first: bool = False


# the single-request engine emits token events only; the batched engine's
# finish / reject events join this union when it is ported
Event = TokenEvent
