"""Streaming request-handle front-end over the continuous-batching engine
(port of ``repro.serving.frontend``).

Callers submit a typed ``GenerationRequest`` and get back a live
``RequestHandle``: an iterator that yields tokens as the engine emits them,
with ``.status``, ``.result()`` and ``.cancel()``. Everything is cooperative
and thread-free: ``ServingFrontend.poll()`` runs exactly one engine
``step()`` and routes its event stream (``serving/api.py``) to the right
handles; iterating a handle polls on the caller's behalf until its next
token lands. Because ``poll()`` advances the WHOLE engine
deterministically, the tokens each handle yields at temperature 0 are the
same for every poll/read schedule, and the same as ``run_until_drained()``
on the same workload.

    fe = ServingFrontend(BatchedServingEngine(cfg, params, ...))
    h = fe.submit(GenerationRequest(prompt=ids,
                                    params=SamplingParams(max_new_tokens=32),
                                    ttft_slo=0.5, priority=1))
    for tok in h:                  # streams; first iteration shows TTFT
        if deadline_blown():
            h.cancel()             # frees KV slot + expert budget NOW
            break
    r = h.result()                 # RequestResult (partial if cancelled)

Cancellation is synchronous: when ``cancel()`` returns, the request's KV
slot is back in the free pool, its expert-residency contributions are
dropped from the shared ledger, its TBT-ledger entry is closed, and the
handle is terminal: the engine will never emit another event for it.
``pause`` / ``resume`` move a request through a host-side
``RequestSnapshot`` (its KV rows as host tensors) and rebind the handle.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

from repro_torch.obs.spans import monotonic
from repro_torch.serving.api import (Event, FinishEvent, RejectEvent,
                               RequestSnapshot, StepEvents, TokenEvent,
                               as_request_spec)
from repro_torch.serving.batching import BatchedServingEngine, Request
from repro_torch.serving.engine import RequestResult


class RequestHandle:
    """Live handle for one submitted request.

    tokens: generated token ids received so far (grows as the engine runs).
    events: this request's full event stream (Token/Finish/Reject).
    Iterating the handle yields each generated token exactly once, driving
    ``frontend.poll()`` cooperatively while the next token is pending, and
    stops at the request's FinishEvent (or Reject/cancel).
    """

    def __init__(self, frontend, req: Request):
        self._fe = frontend   # ServingFrontend or cluster.ClusterFrontend
        self.req = req
        self.rid = req.rid
        self.replica: Optional[int] = None   # set by ClusterFrontend.submit
        self.tokens: List[int] = []
        self.events: List[Event] = []
        self.finish_reason: Optional[str] = None  # incl. 'rejected'
        self.last_token_t: Optional[float] = None  # wall time of last token
        # one record per snapshot/restore hop this request took (disagg
        # prefill->decode handoff, preemption resume, drain migration):
        # {"t_snapshot", "t_restore", "src", "dst"} — replica indices are
        # None for plain-frontend pauses. Handoff latency = first
        # TokenEvent.t after t_snapshot minus t_snapshot.
        self.handoffs: List[dict] = []
        self._cursor = 0

    # -- state ---------------------------------------------------------------
    @property
    def status(self) -> str:
        """Engine-side lifecycle state: queued | prefilling | running |
        held (prefill done, awaiting KV handoff) | paused (host-side
        snapshot, will resume) | done | rejected | cancelled."""
        return self.req.state

    @property
    def done(self) -> bool:
        """Terminal: finished, rejected, or cancelled — no further events
        will ever arrive for this handle."""
        return self.finish_reason is not None

    # -- event delivery (called by the frontend dispatcher) ------------------
    def _on_event(self, ev: Event) -> None:
        assert not self.done, \
            f"event {ev} for terminal request {self.rid} (engine bug)"
        self.events.append(ev)
        if isinstance(ev, TokenEvent):
            self.tokens.append(ev.token)
            self.last_token_t = ev.t
        elif isinstance(ev, FinishEvent):
            self.finish_reason = ev.reason
        elif isinstance(ev, RejectEvent):
            self.finish_reason = "rejected"

    # -- streaming -----------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        polls = 0
        while self._cursor >= len(self.tokens) and not self.done:
            ev = self._fe.poll()
            polls += 1
            if not ev.did_work and self._fe.idle and not self.done:
                raise RuntimeError(
                    f"request {self.rid} cannot advance: engine idle")
            assert polls < 1_000_000, "handle iteration did not progress"
        if self._cursor < len(self.tokens):
            tok = self.tokens[self._cursor]
            self._cursor += 1
            return tok
        raise StopIteration

    # -- completion ----------------------------------------------------------
    def result(self, max_steps: int = 100_000) -> RequestResult:
        """Drive the engine until this request is terminal and return its
        RequestResult (partial tokens + finish_reason='cancelled' for a
        cancelled request). Raises for a rejected request — it never ran."""
        for _ in range(max_steps):
            if self.done:
                break
            self._fe.poll()
        assert self.done, f"request {self.rid} not terminal in {max_steps}"
        if self.finish_reason == "rejected":
            raise RuntimeError(
                f"request {self.rid} was rejected at admission (SLO shed)")
        return self.req.result()

    def cancel(self, reason: str = "cancelled") -> bool:
        """Cancel this request (see BatchedServingEngine.cancel). When this
        returns True the handle is terminal, the engine has reclaimed the
        request's KV slot / expert-residency / TBT-ledger resources, and no
        further events will ever arrive. False if already terminal.
        `reason` becomes the FinishEvent reason — the QosAutopilot passes
        "slo_shed" so shed requests are distinguishable from caller
        cancellations."""
        return self._fe.cancel(self, reason=reason)


class CooperativeDriver:
    """Shared cooperative poll-loop surface for any front-end exposing
    ``poll()`` + ``idle`` (ServingFrontend here, ClusterFrontend in
    serving/cluster.py) — one definition so the two surfaces cannot
    drift."""

    autopilot = None   # QosAutopilot registers itself here

    def drain(self, max_steps: int = 100_000) -> None:
        """Poll until idle (the frontend analogue of ``run_until_drained``;
        callers read results off the handles they kept from ``submit``)."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.poll()

    def _cancel_paused(self, handle: RequestHandle, reason: str) -> bool:
        """Terminate a host-paused request: the engine holds nothing for
        it, so cancellation is dropping the snapshot (the autopilot's, if
        it is the owner) and finishing the handle directly."""
        ap = self.autopilot
        if ap is not None:
            ap.paused = [(h, s) for (h, s) in ap.paused if h is not handle]
        req = handle.req
        req.state = "cancelled"
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        # the engine never sees this cancel, so record the terminal span
        # here on the recorder of the engine that last ran the request
        # (rid is still that engine's — restore would have re-rid'd it)
        self.engine_of(handle).obs.terminal(req.rid, reason,
                                            n_tokens=len(req.tokens))
        handle._on_event(FinishEvent(rid=req.rid, reason=reason,
                                     n_tokens=len(req.tokens), t=req.t_done))
        return True


class ServingFrontend(CooperativeDriver):
    """Event-driven front-end owning the engine step loop.

    One cooperative driver: each ``poll()`` runs one ``engine.step()`` and
    dispatches the resulting events to the submitted handles. No threads —
    callers interleave ``poll()`` with their own logic (or just iterate a
    handle / call ``result()`` and let the handle poll for them).
    """

    def __init__(self, engine: BatchedServingEngine):
        self.engine = engine
        self._handles: Dict[int, RequestHandle] = {}
        # QosAutopilot (serving/cluster.py) registers itself here; poll()
        # then runs its shed scan after dispatching each step's events
        self.autopilot = None

    def submit(self, spec, **kw) -> RequestHandle:
        """Submit a GenerationRequest (or a raw prompt array plus
        GenerationRequest fields as kwargs); returns its RequestHandle."""
        spec = as_request_spec(spec, **kw)
        req = self.engine.submit_request(spec)
        handle = RequestHandle(self, req)
        self._handles[req.rid] = handle
        return handle

    # -- pause / resume (snapshot primitive, serving/api.py) -----------------
    def pause(self, handle: RequestHandle) -> RequestSnapshot:
        """Snapshot `handle`'s request host-side (engine resources released
        like a cancel, NO FinishEvent — the request is paused, not
        terminal) and unregister its event route. The caller owns the
        returned snapshot; ``resume`` it here or on any other frontend."""
        if handle.done:
            raise ValueError("cannot pause a terminal request")
        snap = self.engine.snapshot(handle.req)
        self._handles.pop(handle.rid, None)
        return snap

    def resume(self, snap: RequestSnapshot,
               handle: Optional[RequestHandle] = None, *,
               src: Optional[int] = None,
               dst: Optional[int] = None) -> RequestHandle:
        """Restore a snapshot into this frontend's engine. Pass the
        original handle to keep the caller's streaming surface alive across
        the pause — it is rebound to the restored request (fresh
        engine-local rid) and its event stream simply continues; with no
        handle a fresh one is created (its ``tokens`` pre-seeded with the
        carried prefix). Records the hop on ``handle.handoffs``
        (src/dst: replica indices when a cluster migration drives this)."""
        req = self.engine.restore(snap)
        if handle is None:
            handle = RequestHandle(self, req)
            handle.tokens = list(req.tokens)
        else:
            handle.req = req
            handle.rid = req.rid
        # t_restore comes from the SAME monotonic clock engine.snapshot
        # stamped t_snapshot with (repro_torch.obs.spans.monotonic) — handoff
        # latency is a difference of one clock, never of two
        handle.handoffs.append({
            "t_snapshot": snap.t_snapshot, "t_restore": monotonic(),
            "src": src, "dst": dst})
        self._handles[req.rid] = handle
        return handle

    @property
    def idle(self) -> bool:
        # host-paused requests keep the frontend non-idle: the autopilot
        # that parked them resumes them from a later poll's scan
        return self.engine.idle and not (
            self.autopilot is not None and self.autopilot.paused)

    def poll(self, now: Optional[float] = None) -> StepEvents:
        """Advance the engine one step and deliver its events. With a
        QosAutopilot attached, its shed scan runs after dispatch — a shed
        request is terminal before poll() returns, and its
        FinishEvent("slo_shed") is appended to the returned stream so
        event-stream consumers observe the termination too."""
        events = self.engine.step(now)
        self._dispatch(events)
        if self.autopilot is not None:
            self.autopilot.scan_into(now, events)
        return events

    def live_handles(self) -> List[RequestHandle]:
        """Non-terminal handles (the dispatch table reaps terminal ones) —
        what the QosAutopilot scans."""
        return list(self._handles.values())

    def engine_of(self, handle: RequestHandle) -> BatchedServingEngine:
        """The engine serving `handle` (trivially THE engine here; the
        cluster front-end resolves the owning replica)."""
        return self.engine

    def _dispatch(self, events) -> None:
        for ev in events:
            handle = self._handles.get(ev.rid)
            if handle is None:
                continue  # raw-engine submission or already-reaped handle
            handle._on_event(ev)
            if handle.done:
                # terminal handles receive nothing further — reap the route
                # so a long-running server's dispatch table stays bounded
                del self._handles[ev.rid]

    def cancel(self, handle: RequestHandle, reason: str = "cancelled"
               ) -> bool:
        if handle.done:
            return False
        if handle.req.state == "paused":
            return self._cancel_paused(handle, reason)
        ok = self.engine.cancel(handle.req, reason=reason)
        # the engine emitted FinishEvent('cancelled') synchronously; deliver
        # it now so the handle is terminal the moment cancel() returns
        self._dispatch(StepEvents(self.engine.drain_events()))
        return ok
